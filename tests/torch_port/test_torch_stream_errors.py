"""Error propagation through the port's threaded device streams, after
``tests/test_stream_errors.py``: a failure on the feeder thread (the step's
dispatch) or on the drainer thread (the wait for the payload) surfaces as
an exception to the consumer at the next flush point, never a hang and
never silently missing reads. Each case also runs with NTLINK_TIMING=1, so
that the stream's accounting can neither swallow nor delay an error."""
import time

import numpy as np
import pytest

from ntlink_tpu.index import ContigIndex
from ntlink_tpu.ops import nthash_np
from ntlink_tpu_torch import device_map, sketch, stream_pipeline
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.sketch import TorchSketcher

K, W = 32, 100


@pytest.fixture(scope="module")
def small_index():
    rng = np.random.default_rng(3)
    contig = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 50_000)])
    index = ContigIndex.from_sketches(
        [("c0", nthash_np.sketch_sequence(contig, K, W))]
    )
    return index, contig


def _reads(contig, n=40, ln=900):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        s = int(rng.integers(0, len(contig) - ln))
        out.append((f"r{i}", contig[s : s + ln]))
    return out


class Boom(RuntimeError):
    pass


def test_feeder_error_propagates(small_index, timing_env, monkeypatch,
                                 capsys):
    index, contig = small_index
    mapper = TorchMapper(index, K, W, batch_bases=8_192, device="cpu")

    def bad_step(*a, **kw):
        raise Boom("dispatch failed")

    monkeypatch.setattr(device_map, "mapping_step", bad_step)
    t0 = time.time()
    with pytest.raises(Boom):
        list(mapper.map_stream_raw(iter(_reads(contig))))
    assert time.time() - t0 < 60
    # the stream closed in order: its accounting is there when asked for
    assert ("# ntlink timing" in capsys.readouterr().err) == timing_env
    assert ("pack" in mapper.last_timing) == timing_env
    assert "dispatch" not in mapper.last_timing


def test_drainer_error_propagates(small_index, timing_env, monkeypatch):
    index, contig = small_index
    mapper = TorchMapper(index, K, W, batch_bases=8_192, device="cpu")

    class Poison:
        """A payload whose host view fails, as a lost device would at the
        drainer's wait."""

        def numpy(self):
            raise Boom("transfer failed")

    monkeypatch.setattr(stream_pipeline, "copy_back",
                        lambda out: (Poison(), None))
    with pytest.raises(Boom):
        list(mapper.map_stream_raw(iter(_reads(contig))))
    assert mapper.wire_stats["d2h"] == 0 < mapper.wire_stats["h2d"]
    assert ("dispatch" in mapper.last_timing) == timing_env
    assert "drain_decode" not in mapper.last_timing


def test_abandoned_generator_closes_promptly(small_index, timing_env):
    """Breaking out of the stream with batches in flight shuts the pipeline
    down (bounded close): no hang, and a fresh stream still works."""
    index, contig = small_index
    mapper = TorchMapper(index, K, W, batch_bases=8_192, device="cpu")
    stream = mapper.map_stream_raw(iter(_reads(contig, n=60)))
    for _ in stream:
        break  # abandon with batches in flight
    t0 = time.time()
    stream.close()
    assert time.time() - t0 < 60
    n = sum(1 for _ in mapper.map_stream_raw(iter(_reads(contig, n=10))))
    assert n == 10
    if timing_env:
        assert mapper.last_timing["reader_pull"][1] == 1   # one block


def test_sketcher_feeder_error_propagates(timing_env, monkeypatch):
    def bad_step(*a, **kw):
        raise Boom("sketch dispatch failed")

    monkeypatch.setattr(sketch, "sketch_step", bad_step)
    rng = np.random.default_rng(5)
    contig = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30_000)])
    sk = TorchSketcher("cpu", batch_bases=4_096)
    seqs = [(f"s{i}", contig[i * 1000 : i * 1000 + 2000]) for i in range(20)]
    with pytest.raises(Boom):
        list(sk.sketch_stream(iter(seqs), K, W))
