"""The read stream's drainer decode (`_ReadBatches.decode`), which decodes
a device block's payload once over the block and gives each read slices of
those arrays, against a plain per-read decoder kept here as the reference:
every payload layout and mode, with remap, empty and padding rows, a batch
split into two device blocks, and the hash-sharded grid's planes with the
packed global positions. Then the stream's ``map/decode`` count, taken
only while the Tracer is on, against a recount from the step's payloads."""
import types

import numpy as np
import pytest

from ntlink_tpu_torch import device_map, tracing
from ntlink_tpu_torch.chain import RUN_LANES
from ntlink_tpu_torch.device_map import TorchMapper, _Remap
from ntlink_tpu_torch.index import ContigIndex
from ntlink_tpu_torch.ops import nthash_np
from ntlink_tpu_torch.parallel.sharded_index import ShardedDeviceIndex

K, W = 32, 100
SLOTS = 48


def reference_decode(stream, flat, slots, lo, hi, tags, rows):
    """One read at a time: the decoder the block-wise one replaced."""
    m = stream.mapper
    count, n_mins, planes = m._steps.payload(stream, flat, hi - lo, slots)
    hi = min(hi, len(tags))
    results = stream.results
    if m.runs_only:
        slots = RUN_LANES
        total = int(count.sum())
        cid, cnt, f_cpos, l_cpos, f_rw, l_rw = planes[:, :total]
        runs = np.stack([
            cid, cnt, f_cpos, f_rw & 0x1FFFFFFF, (f_rw >> 29) & 3,
            l_cpos, l_rw & 0x1FFFFFFF, (l_rw >> 29) & 3,
        ], axis=1)
    offs = np.zeros(len(count) + 1, np.int64)
    np.cumsum(count, out=offs[1:])
    for row in range(lo, hi):
        i = tags[row]
        r = row - lo
        n = int(count[r])
        if n_mins[r] > slots:
            results[i] = _Remap(rows[row])
            continue
        if n == 0:
            results[i] = None
            continue
        o = int(offs[r])
        if m.runs_only:
            results[i] = (n, runs[o : o + n])
            continue
        rw = planes[0][o : o + n]
        if m.with_hashes:
            hi_, lo_ = planes[3][o : o + n], planes[4][o : o + n]
        else:
            hi_ = lo_ = np.zeros(n, np.int32)
        results[i] = (
            n, rw & 0x1FFFFFFF, planes[1][o : o + n],
            planes[2][o : o + n], (rw >> 29) & 3, hi_, lo_,
        )


def _stream(layout, runs_only, with_hashes, didx=None):
    m = types.SimpleNamespace(
        runs_only=runs_only, with_hashes=with_hashes,
        join_stats={"slots": 0, "queries": 0, "bucket_bytes": 0},
        decode_stats={"blocks": 0, "rows": 0, "remaps": 0, "empty": 0})
    if layout == "grid":
        m._steps = device_map._HashGrid.__new__(device_map._HashGrid)
        m._steps.didx = didx
    else:
        m._steps = device_map._ReplicaSet.__new__(device_map._ReplicaSet)
        m._steps.mapper = m
    return types.SimpleNamespace(mapper=m, results={}, counting=True)


def _meta(rng, B, n_rows, lane_cap, over):
    """(count, n_mins) of a block of B rows, the first n_rows of them
    reads: about a fifth empty, a tenth over their budget, and the
    padding rows empty."""
    count = rng.integers(1, lane_cap + 1, B)
    n_mins = rng.integers(0, lane_cap + 1, B)
    kind = rng.random(B)
    count[kind < 0.2] = 0
    n_mins[(kind >= 0.2) & (kind < 0.3)] = over
    count[n_rows:] = 0
    n_mins[n_rows:] = 0
    return count.astype(np.int32), n_mins.astype(np.int32)


def _replica_flat(rng, B, n_rows, runs_only, with_hashes):
    lanes = RUN_LANES if runs_only else SLOTS
    count, n_mins = _meta(rng, B, n_rows, lanes,
                          RUN_LANES + 1 if runs_only else SLOTS + 1)
    n_planes = 6 if runs_only else 5 if with_hashes else 3
    planes = rng.integers(-2**31, 2**31, (n_planes, B * lanes))
    return np.concatenate([count, n_mins, planes.ravel()]).astype(np.int32)


def _grid_index(rng):
    n = 2000
    return ShardedDeviceIndex(
        np.unique(rng.integers(1, 2**64 - 1, n, dtype=np.uint64)),
        rng.integers(0, 7, n).astype(np.int32),
        rng.integers(0, 90_000, n).astype(np.int32),
        rng.integers(0, 2, n).astype(bool), 1)


def _grid_flat(rng, B, n_rows, with_hashes, didx):
    """Meta in row 0, then rpos-and-strand, gpos and the hash planes."""
    count, n_mins = _meta(rng, B, n_rows, SLOTS, SLOTS + 1)
    lanes = B * SLOTS
    off = didx.host_offsets
    cid = rng.integers(0, len(off) - 1, lanes)
    gpos = off[cid] + rng.integers(0, off[cid + 1] - off[cid])
    planes = [rng.integers(-2**31, 2**31, lanes),
              gpos.astype(np.uint32).view(np.int32)]
    if with_hashes:
        planes += list(rng.integers(-2**31, 2**31, (2, lanes)))
    meta = np.zeros(lanes, np.int64)
    meta[:B], meta[B : 2 * B] = count, n_mins
    return np.stack([meta, *planes]).astype(np.int32)


def _same_results(got, want):
    assert got.keys() == want.keys()
    for i, w in want.items():
        g = got[i]
        if w is None or isinstance(w, _Remap):
            assert type(g) is type(w), i
            if w is not None:
                assert g.codes is w.codes, i
            continue
        assert len(g) == len(w) and g[0] == w[0] and type(g[0]) is int, i
        for a, b in zip(g[1:], w[1:]):
            assert a.dtype == b.dtype == np.int32, i
            assert a.shape == b.shape and a.shape[0] == w[0], i
            assert np.array_equal(a, b), i


CASES = {
    # name: (layout, runs_only, with_hashes, blocks)
    "anchors": ("replica", False, False, 1),
    "hashes": ("replica", False, True, 1),
    "runs_only": ("replica", True, False, 1),
    "split": ("replica", False, False, 2),
    "runs_only_split": ("replica", True, False, 2),
    "hash_grid": ("grid", False, False, 1),
    "hash_grid_hashes": ("grid", False, True, 1),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_block_decode_equals_the_per_read_decoder(case, seed):
    layout, runs_only, with_hashes, blocks = CASES[case]
    rng = np.random.default_rng(seed)
    B, n_rows = 64, 53
    # the batch's tags: each read's index since the last flush_all
    tags = sorted(rng.choice(1000, n_rows, replace=False).tolist())
    rows = [rng.integers(0, 4, 50).astype(np.uint8) for _ in range(n_rows)]
    didx = _grid_index(rng) if layout == "grid" else None
    assert layout != "grid" or didx.t_off is not None
    got = _stream(layout, runs_only, with_hashes, didx)
    want = _stream(layout, runs_only, with_hashes, didx)
    bounds = [B * b // blocks for b in range(blocks + 1)]
    meta = []
    for lo, hi in zip(bounds, bounds[1:]):
        n = max(0, min(hi, n_rows) - lo)
        flat = (_grid_flat(rng, hi - lo, n, with_hashes, didx)
                if layout == "grid" else
                _replica_flat(rng, hi - lo, n, runs_only, with_hashes))
        device_map._ReadBatches.decode(got, flat.copy(), SLOTS, lo, hi,
                                       tags, rows)
        reference_decode(want, flat.copy(), SLOTS, lo, hi, tags, rows)
        head = flat[0] if layout == "grid" else flat
        meta.append((head[: hi - lo][:n], head[hi - lo : 2 * (hi - lo)][:n]))
    _same_results(got.results, want.results)
    assert len(got.results) == n_rows
    count = np.concatenate([c for c, _ in meta])
    over = np.concatenate([o for _, o in meta]) > (
        RUN_LANES if runs_only else SLOTS)
    kinds = {"remap": over.sum(), "empty": ((count == 0) & ~over).sum(),
             "full": ((count > 0) & ~over).sum()}
    assert min(kinds.values()) > 0, kinds
    assert got.mapper.decode_stats == {
        "blocks": blocks, "rows": kinds["full"], "remaps": kinds["remap"],
        "empty": kinds["empty"]}


def _mapper_dataset():
    rng = np.random.default_rng(17)
    contigs = [rng.integers(0, 4, 60_000).astype(np.uint8) for _ in range(2)]
    index = ContigIndex.from_sketches(
        (f"c{i}", nthash_np.sketch_codes(c, K, W))
        for i, c in enumerate(contigs))
    reads = []
    lens = [10, K - 1] + list(rng.integers(300, 1024, 30)) + list(
        rng.integers(2000, 6000, 10))
    for r, n in enumerate(lens):
        c = contigs[r % 2]
        s = int(rng.integers(0, len(c) - n))
        read = c[s : s + n].copy()
        if r % 3 == 0:  # no anchor on the table
            read = rng.integers(0, 4, n).astype(np.uint8)
        reads.append((f"r{r}", read))
    return index, reads


@pytest.mark.parametrize("enabled", [True, False], ids=["tracer", "off"])
def test_decode_count_recounts_the_stream(enabled, monkeypatch):
    """While the Tracer is on, each stream's ``map/decode`` count holds its
    device blocks and their rows with anchors, remapped and empty,
    recounted from every step call's payload; with it off nothing is
    counted. A shrunk slot budget makes the longer reads overflow."""
    for name, value in (("enabled", enabled), ("spans", []), ("counts", [])):
        monkeypatch.setattr(tracing.GLOBAL, name, value)
    calls = []
    real = device_map.mapping_step

    def step(packed, lengths, index, k, w, L, slots, **kw):
        out = real(packed, lengths, index, k, w, L, slots, **kw)
        calls.append((packed.shape[0], int((lengths > 0).sum()), slots,
                      out.numpy().copy()))
        return out
    monkeypatch.setattr(device_map, "mapping_step", step)
    index, reads = _mapper_dataset()
    tm = TorchMapper(index, K, W, batch_bases=65536, device="cpu")
    tm._slots_for = lambda L: 64
    per_stream = []
    for _ in range(2):
        calls.clear()
        fallbacks, device_reads = tm.host_fallbacks, tm.device_reads
        got = list(tm.map_stream_raw(iter(reads)))
        assert len(got) == len(reads)
        want = {"blocks": len(calls), "rows": 0, "remaps": 0, "empty": 0}
        for B, n, slots, out in calls:
            count, over = out[:n], out[B : B + n] > slots
            want["rows"] += int(((count > 0) & ~over).sum())
            want["remaps"] += int(over.sum())
            want["empty"] += int(((count == 0) & ~over).sum())
        # the two sub-k reads never reach the device
        assert want["remaps"] == tm.host_fallbacks - fallbacks - 2
        assert want["rows"] + want["empty"] == tm.device_reads - device_reads
        assert sum(r is not None for _, _, r in got) >= want["rows"]
        assert min(want.values()) > 0, want
        per_stream.append(want)
    if not enabled:
        assert tracing.GLOBAL.counts == []
        assert set(tm.decode_stats.values()) == {0}
        return
    assert tracing.GLOBAL.counts_named("map/decode") == per_stream
    assert tm.decode_stats == {key: 2 * v for key, v in per_stream[0].items()}
