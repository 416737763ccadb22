"""The read stream's own accounting in ``TorchMapper``, the counterparts of
``ntlink_tpu/device_map.py``'s NTLINK_TIMING (:362-372, :666-676),
`wire_stats` (:165, :438-445) and NTLINK_PIPE_DEPTH (:572), on the CPU
device: the ``# ntlink timing:`` line and `last_timing`, the byte counts
against the batches that ran, and the pipeline depth. With each of them on,
every read's raw payload is what it is without, and what ``DeviceMapper``
gives. Inputs come from numpy seeds; every comparison is exact."""
import re

import numpy as np
import pytest

from ntlink_tpu.device_map import DeviceMapper
from ntlink_tpu_torch import device_map, stream_pipeline
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.stream_pipeline import PhaseTimer

from .test_torch_device_map import K, W, _dataset, _raws, _same, _same_runs

#: the keys of `PhaseTimer.THREADS` that a mapper's own stream times: all
#: but the consumer's (``pipeline.map_reads``) and the reader thread's
#: (``prefetch_files``), which a bare `map_stream_raw` does not run
CONSUMER = ("group_gather", "chain_render", "verbose_write", "tally")
KEYS = tuple(k for thread, keys in PhaseTimer.THREADS.items()
             if thread != "reader" for k in keys if k not in CONSUMER)
#: the keys timed once per batch
PER_BATCH = (("pack", "feed_enqueue_wait") + PhaseTimer.THREADS["feeder"]
             + PhaseTimer.THREADS["drainer"])
LINE = re.compile(r"^# ntlink timing: (.*)$", re.M)
PRECHAIN = (np.full(3, 150_000, np.int32), 1000)


def _row_bytes(key):
    """Bytes of one uploaded row: 2-bit codes, its int32 length, and the
    1-bit N mask of an N batch."""
    pad, has_n = key
    return pad // 4 + 4 + (pad // 8 if has_n else 0)


def test_timing_line_and_last_timing(monkeypatch, capsys):
    index, reads = _dataset()
    monkeypatch.delenv("NTLINK_TIMING", raising=False)
    plain = TorchMapper(index, K, W, batch_bases=65536, device="cpu")
    want = _raws(plain, reads)
    assert plain.last_timing == {}
    assert "# ntlink timing" not in capsys.readouterr().err

    monkeypatch.setenv("NTLINK_TIMING", "1")
    tm = TorchMapper(index, K, W, batch_bases=65536, device="cpu")
    got = _raws(tm, reads)
    wall = tm.stream_seconds  # the mapper's first stream
    err = capsys.readouterr().err
    lines = LINE.findall(err)
    assert len(lines) == 1
    parsed = {}
    for item in lines[0].split():
        key, rest = item.split("=")
        secs, spans = rest.split("s/")
        parsed[key] = (float(secs), int(spans))
    assert list(parsed) == sorted(KEYS)  # every key, sorted
    n_batches = sum(tm.batches_by_pad.values())
    assert n_batches >= 8
    for key in PER_BATCH:
        assert parsed[key][1] == n_batches, key
    # one pull per block of the per-record reads
    assert parsed["reader_pull"][1] == tm.read_blocks == -(
        -len(reads) // device_map.PAIR_BLOCK_READS)
    assert set(tm.last_timing) == set(KEYS)
    for key, (secs, spans) in tm.last_timing.items():
        assert spans == parsed[key][1]
        assert secs == pytest.approx(parsed[key][0], abs=1e-3)
        assert secs >= 0.0
    # one thread's keys cannot sum past the stream's wall
    for thread in PhaseTimer.THREADS.values():
        assert sum(tm.last_timing.get(k, (0.0, 0))[0] for k in thread) <= wall
    # the payloads: unchanged, and DeviceMapper's
    dm = DeviceMapper(index, K, W, batch_bases=65536, use_mesh=False,
                      with_hashes=False, prechain=None)
    for ref in (want, _raws(dm, reads)):
        assert len(ref) == len(got)
        for a, b in zip(got, ref):
            _same(a, b)
    # a second stream replaces the first one's numbers
    _raws(tm, reads[:5])
    assert tm.last_timing["reader_pull"][1] == 1


def test_timing_is_read_once_per_stream(monkeypatch, capsys):
    """Setting the variable after the stream began changes nothing in it."""
    index, reads = _dataset()
    monkeypatch.delenv("NTLINK_TIMING", raising=False)
    tm = TorchMapper(index, K, W, batch_bases=65536, device="cpu")
    stream = tm.map_stream_raw(iter(reads))
    next(stream)
    monkeypatch.setenv("NTLINK_TIMING", "1")
    assert len(list(stream)) == len(reads) - 1
    assert tm.last_timing == {}
    assert "# ntlink timing" not in capsys.readouterr().err


@pytest.mark.parametrize("layout", ["one device", "two devices", "hash grid",
                                    "hash grid, one device", "runs only"])
def test_wire_stats_count_the_batches_bytes(layout, monkeypatch):
    """`h2d` is the bytes of the rows that went to a device (on the hash
    grid once per distinct device: each of two devices gets the batch, a
    device named twice gets it once), `d2h` the bytes of every payload
    that came back; both counted here from the calls that move them."""
    index, reads = _dataset()
    kw = {
        "one device": dict(device="cpu"),
        "two devices": dict(devices=["cpu"] * 2),
        "hash grid": dict(devices=["cpu:0", "cpu:1"], index_sharding="hash",
                          idx_shards=2),
        "hash grid, one device": dict(devices=["cpu"] * 2,
                                      index_sharding="hash", idx_shards=2),
        "runs only": dict(device="cpu", prechain=PRECHAIN, runs_only=True),
    }[layout]
    tm = TorchMapper(index, K, W, batch_bases=65536, **kw)
    assert tm.wire_stats == {"h2d": 0, "d2h": 0, "h2d_s": 0.0, "d2h_s": 0.0}
    up, down, rows_by_pad = [], [], {}
    real_pinned = stream_pipeline.pinned
    real_back = stream_pipeline.copy_back

    def pinned(device, *arrays):
        up.append(sum(a.nbytes for a in arrays if a is not None))
        packed, lengths, nmask = arrays
        key = (packed.shape[1] * 4, nmask is not None)
        rows_by_pad[key] = rows_by_pad.get(key, 0) + len(lengths)
        return real_pinned(device, *arrays)

    def copy_back(out):
        down.append(out.numel() * out.element_size())
        return real_back(out)

    monkeypatch.setattr(stream_pipeline, "pinned", pinned)
    monkeypatch.setattr(stream_pipeline, "copy_back", copy_back)
    got = _raws(tm, reads)
    copies = 2 if layout == "hash grid" else 1
    assert tm.idx_shards == (2 if layout.startswith("hash") else 1)
    n_batches = sum(tm.batches_by_pad.values())
    assert len(up) >= n_batches and len(down) >= n_batches
    if layout == "two devices":
        assert len(up) > n_batches  # a batch's rows split over the replicas
    assert tm.wire_stats["h2d"] == copies * sum(up) > 0
    assert tm.wire_stats["h2d"] == copies * sum(
        rows * _row_bytes(key) for key, rows in rows_by_pad.items())
    # the rows that went to a device: a replica whose block holds padding
    # alone gets none, so a batch may upload fewer than its height
    assert set(rows_by_pad) == set(tm.batches_by_pad)
    assert any(has_n for _, has_n in rows_by_pad)
    for key, rows in rows_by_pad.items():
        full = stream_pipeline.batch_rows(key[0], 65536) * tm.batches_by_pad[key]
        assert 0 < rows <= full
    assert tm.wire_stats["d2h"] == sum(down) > 0
    assert tm.wire_stats["h2d_s"] > 0.0 and tm.wire_stats["d2h_s"] >= 0.0
    # the counters run on over a second stream; the payloads are the same
    first = dict(tm.wire_stats)
    again = _raws(tm, reads)
    assert tm.wire_stats["h2d"] == 2 * first["h2d"]
    assert tm.wire_stats["d2h"] == 2 * first["d2h"]
    same = _same_runs if layout == "runs only" else _same
    for a, b in zip(got, again):
        same(a, b)


@pytest.mark.parametrize("depth", ["1", "8"])
def test_pipe_depth_is_honoured_and_changes_no_payload(depth, monkeypatch):
    index, reads = _dataset()
    monkeypatch.delenv("NTLINK_PIPE_DEPTH", raising=False)
    depths = []
    real = stream_pipeline.DevicePipeline

    def pipeline(dispatch, drain, depth, name):
        depths.append(depth)
        return real(dispatch, drain, depth=depth, name=name)

    monkeypatch.setattr(stream_pipeline, "DevicePipeline", pipeline)
    tm = TorchMapper(index, K, W, batch_bases=65536, device="cpu",
                     prechain=PRECHAIN)
    want = _raws(tm, reads)
    monkeypatch.setenv("NTLINK_PIPE_DEPTH", depth)
    got = _raws(tm, reads)
    assert depths == [TorchMapper.DEPTH, int(depth)] and depths[0] == 4
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b)
    dm = DeviceMapper(index, K, W, batch_bases=65536, use_mesh=False,
                      with_hashes=False, prechain=PRECHAIN)
    for a, b in zip(got, _raws(dm, reads)):
        _same(a, b)
