"""TorchMapper (the port's read mapper) against ntlink_tpu's DeviceMapper
(JAX on the CPU) and HostMapper, read by read, on reads that reach every
branch: sub-k, no window, N-containing, every pad from 1024 to 65536, and
partial-flush tails."""
import numpy as np
import pytest

from ntlink_tpu.device_map import DeviceMapper
from ntlink_tpu.host_map import HostMapper
from ntlink_tpu.index import ContigIndex
from ntlink_tpu.ops import nthash_np
from ntlink_tpu_torch.device_map import TorchMapper

K, W = 32, 100


def _dataset():
    rng = np.random.default_rng(31)
    contigs = [rng.integers(0, 4, 150_000).astype(np.uint8) for _ in range(3)]
    index = ContigIndex.from_sketches(
        (f"c{i}", nthash_np.sketch_codes(c, K, W))
        for i, c in enumerate(contigs)
    )
    lens = (
        [10, K - 1, K + W - 2, K + W - 1, 1024, 1025, 16384]
        + list(rng.integers(300, 1024, 40))
        + list(rng.integers(2000, 4000, 12))
        + [16385, 23000, 40000]
    )
    reads = []
    for r, n in enumerate(lens):
        c = contigs[r % 3]
        s = int(rng.integers(0, len(c) - n))
        read = c[s : s + n].copy()
        err = rng.random(n) < 0.05
        read[err] = rng.integers(0, 4, err.sum())
        if r % 2:
            read = (3 - read)[::-1].copy()
        reads.append((f"r{r}", read))
    # non-ACGT bases: interior N, N at both ends
    for r in (9, 20, 50):
        read = reads[r][1].copy()
        read[len(read) // 2] = 4
        reads[r] = (reads[r][0], read)
    read = reads[30][1].copy()
    read[0] = read[-1] = 4
    reads[30] = (reads[30][0], read)
    return index, reads


def _raws(mapper, reads):
    return list(mapper.map_stream_raw(iter(reads)))


def _same(a, b):
    assert a[:2] == b[:2]
    ra, rb = a[2], b[2]
    assert (ra is None) == (rb is None), a[0]
    if ra is None:
        return
    assert ra[0] == rb[0], a[0]
    for x, y in zip(ra[1:5], rb[1:5]):  # rpos, cid, cpos, sbits
        assert np.array_equal(x[: ra[0]], y[: rb[0]]), a[0]


@pytest.mark.parametrize("batch_bases", [65536, 8_000_000])
def test_torch_mapper_matches_device_and_host(batch_bases):
    index, reads = _dataset()
    tm = TorchMapper(index, K, W, batch_bases=batch_bases, device="cpu")
    got = _raws(tm, reads)
    dm = DeviceMapper(index, K, W, batch_bases=batch_bases, use_mesh=False,
                      with_hashes=False, prechain=None)
    hm = HostMapper(index, K, W, threads=1)
    for want in (_raws(dm, reads), _raws(hm, reads)):
        assert len(want) == len(got)
        for a, b in zip(got, want):
            _same(a, b)
    assert sum(r[2] is not None for r in got) > 40
    # sub-k (2) + non-ACGT (4) reads take the exact host path
    assert tm.host_fallbacks == 6
    assert tm.device_reads == len(reads) - 6
    assert not tm.prechained and not tm.runs_only


def test_map_stream_hits_match_host():
    index, reads = _dataset()
    tm = TorchMapper(index, K, W, batch_bases=65536, device="cpu")
    hm = HostMapper(index, K, W, threads=1)
    # AnchorHit minus the hash (device rows carry no hash planes)
    hm_hits = {
        name: [(c, *h[1:]) for c, h in hits]
        for name, _, hits in DeviceMapper.map_stream(hm, iter(reads))
    }
    n_hits = 0
    for name, _, hits in tm.map_stream(iter(reads)):
        assert [(c, *h[1:]) for c, h in hits] == hm_hits[name], name
        n_hits += len(hits)
    assert n_hits > 0


def test_slot_overflow_rows_remap_on_host():
    """Rows over their minimizer slot budget are mapped again on the exact
    host path, in order, and counted."""
    index, reads = _dataset()
    tm = TorchMapper(index, K, W, batch_bases=65536, device="cpu")
    tm._slots_for = lambda L: 16
    got = _raws(tm, reads)
    for a, b in zip(got, _raws(HostMapper(index, K, W, threads=1), reads)):
        _same(a, b)
    assert tm.host_fallbacks > 6 + 10
    assert tm.device_reads + tm.host_fallbacks == len(reads)
