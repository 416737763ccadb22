"""The hybrid stream's behaviour around a ``TorchMapper``, after the cases
of ``tests/test_hybrid_map.py`` that need no reference files: a worker's
error reaches the consumer, an idle path flushes its partial batches, a
stalled path is rescued by the idle one (also past a stale FIFO window),
and a crashed mapping leaves no partial checkpoint. Where a case checks
payloads, the reference is ``ntlink_tpu``'s exact host path
(``DeviceMapper._host_map_raw``) on the same reads, compared exactly. Each
case also runs with NTLINK_TIMING=1, so that the stream's accounting can
neither swallow nor delay an error."""
import os
import threading
import time

import numpy as np
import pytest

from ntlink_tpu.device_map import DeviceMapper
from ntlink_tpu.index import ContigIndex
from ntlink_tpu.ops import nthash_np as nt
from ntlink_tpu_torch import device_map, pipeline
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.host_map import HostMapper
from ntlink_tpu_torch.hybrid_map import (
    HybridMapper, HybridStream, _ReorderSink, _Runner,
)

K, W = 32, 100
pytestmark = pytest.mark.usefixtures("timing_env")


def _workload(n_reads=100, seed=9):
    rng = np.random.default_rng(seed)
    contig = "".join("ACGT"[c] for c in rng.integers(0, 4, 120_000))
    index = ContigIndex.from_sketches(
        [("c1", nt.sketch_sequence(contig, K, W))]
    )
    reads = []
    for i in range(n_reads):
        s = int(rng.integers(0, 100_000))
        ln = int(rng.integers(K, 6_000))
        codes = nt.encode(contig[s : s + ln])
        if i % 7 == 0:
            codes = codes.copy()
            codes[rng.integers(0, len(codes), 5)] = 4
        reads.append((f"r{i}", codes))
    return index, reads


def _same_as_the_jax_package(index, reads, got):
    """`got`, a stream's (name, length, raw) triples, against the JAX
    package's mapper's own exact host path on `reads`: names and lengths in
    order, and each payload's anchor count, read positions, contig ids,
    contig positions and strand bits."""
    ref = DeviceMapper(index, K, W, batch_bases=65_536, use_mesh=False)
    assert [g[:2] for g in got] == [(n, len(c)) for n, c in reads]
    some = 0
    for (name, codes), (_, _, graw) in zip(reads, got):
        wraw = ref._host_map_raw(codes)
        assert (graw is None) == (wraw is None), name
        if wraw is not None:
            some += 1
            assert graw[0] == wraw[0], name
            for a, b in zip(graw[1:5], wraw[1:5]):
                assert np.array_equal(np.asarray(a)[: wraw[0]],
                                      np.asarray(b)[: wraw[0]]), name
    assert some > len(reads) // 2


def _failing_step(monkeypatch, after: int):
    """Make the device step raise from its `after`-th batch on."""
    real = device_map.mapping_step
    calls = []

    def step(*a, **kw):
        calls.append(1)
        if len(calls) > after:
            raise RuntimeError("boom")
        return real(*a, **kw)

    monkeypatch.setattr(device_map, "mapping_step", step)


def test_hybrid_propagates_worker_errors(monkeypatch):
    """The device path's step fails on its third batch: the hybrid stream
    raises it on the consumer's thread."""
    index, reads = _workload()
    _failing_step(monkeypatch, after=2)
    hy = HybridMapper(
        TorchMapper(index, K, W, batch_bases=65_536, device="cpu"),
        HostMapper(index, K, W, threads=2), host_frac=0.0,
    )
    t0 = time.time()
    with pytest.raises(RuntimeError, match="boom"):
        for _ in hy.map_stream_raw(iter(reads)):
            pass
    assert time.time() - t0 < 60


def test_hybrid_matches_the_device_path_alone():
    """With nothing failing the two paths' payloads are one stream, in
    order: what the device path alone gives, which is the JAX package's
    exact host path's."""
    index, reads = _workload(n_reads=60)
    hy = HybridMapper(
        TorchMapper(index, K, W, batch_bases=65_536, device="cpu"),
        HostMapper(index, K, W, threads=2), host_frac=0.5,
    )
    hy.BLOCK_READS = 8
    got = list(hy.map_stream_raw(iter(reads)))
    assert hy.device_reads + hy.host_reads == len(reads)
    _same_as_the_jax_package(index, reads, got)


def test_idle_path_flushes_partial_batches():
    """A path that stops receiving work flushes its partial batches within
    about IDLE_FLUSH_S (its stream restarts), and does not hold its
    sequence numbers until the end of the input. The path is a TorchMapper
    whose only batch is a partly filled bucket."""
    index, reads = _workload(n_reads=8)
    sink = _ReorderSink()
    r = _Runner("device", TorchMapper(index, K, W, device="cpu"), sink,
                prior_rate=1e6)
    r.start()
    try:
        for first in (0, 4):  # a second wave after the restart works too
            r.submit([(i, *reads[i]) for i in range(first, first + 4)])
            deadline = time.time() + 30.0
            while time.time() < deadline:
                with sink.lock:
                    if len(sink.buf) == first + 4:
                        break
                time.sleep(0.05)
            with sink.lock:
                assert len(sink.buf) == first + 4, "no idle flush"
    finally:
        r.close()
        r.join()
    assert r.error is None


def test_crashed_mapping_leaves_no_partial_checkpoint(tmp_path, monkeypatch):
    """A mapping failure leaves neither verbose_mapping.tsv nor its .tmp: a
    truncated file would be trusted as a complete checkpoint on a rerun."""
    index, reads = _workload(n_reads=80)
    _failing_step(monkeypatch, after=1)
    reads_fa = tmp_path / "reads.fa"
    with open(reads_fa, "w") as fh:
        for name, codes in reads:
            fh.write(f">{name}\n{''.join('ACGTN'[c] for c in codes)}\n")
    cfg = ScaffoldConfig(k=K, w=W, z=1000, reads=[str(reads_fa)])
    verbose = str(tmp_path / "verbose_mapping.tsv")
    mapper = TorchMapper(index, K, W, batch_bases=65_536, device="cpu")
    with pytest.raises(RuntimeError, match="boom"):
        pipeline.map_reads(cfg, index, {"c1": 120_000}, verbose, None, mapper)
    assert not os.path.exists(verbose)
    assert not os.path.exists(verbose + ".tmp")


class _WedgedPath:
    """Consumes input, never produces output."""

    def map_stream_raw(self, named_codes):
        for _ in named_codes:
            threading.Event().wait(3600)
        return
        yield  # pragma: no cover


def _rescued_stream(index, sched, items):
    """Run `sched` over `items` to its end and hold what it delivers
    against the JAX package's exact host path."""
    done = {}

    def run():
        done["out"] = list(sched.stream(iter(items)))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive(), "the hybrid stream hung"
    _same_as_the_jax_package(index, items, done["out"])


def test_stalled_path_rescued_by_idle_path():
    """A path that wedges does not strand the stream: after STALL_RESCUE_S
    the idle path, a TorchMapper, maps the stranded reads again and the
    stream completes with its payloads."""
    index, reads = _workload(n_reads=8)
    sched = HybridStream(_WedgedPath(),
                         TorchMapper(index, K, W, device="cpu"),
                         host_frac=0.0)
    sched.BLOCK_READS = 2
    sched.STALL_RESCUE_S = 0.3
    sched.JOIN_TIMEOUT_S = 1.0
    _rescued_stream(index, sched, reads)


def test_rescue_survives_stale_fifo_window():
    """A wedged runner never pops its fifo, so after enough rescued blocks
    the first `window` entries are all delivered already: the snapshot must
    filter before it windows, or the rescue does nothing for ever."""
    index, reads = _workload(n_reads=32)
    # every block goes to the wedged path; the snapshot window (4 items) is
    # far smaller than the backlog (32)
    sched = HybridStream(_WedgedPath(),
                         TorchMapper(index, K, W, device="cpu"),
                         host_frac=0.0)
    sched.BLOCK_READS = 2
    sched.RESCUE_BLOCKS = 1
    sched.RESCUE_WINDOW_MIN = 4
    sched.STALL_RESCUE_S = 0.2
    sched.STALL_RETRIGGER_S = 0.05
    sched.JOIN_TIMEOUT_S = 1.0
    _rescued_stream(index, sched, reads)
