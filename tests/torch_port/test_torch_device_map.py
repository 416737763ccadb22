"""TorchMapper (the port's read mapper) against ntlink_tpu's DeviceMapper
(JAX on the CPU) and HostMapper, read by read, on reads that reach every
branch: sub-k, no window, N-containing, every pad from 1024 to 65536,
partial-flush tails, and in the prechained and runs-only modes a
slot-overflow row and a run-lane-overflow row."""
import numpy as np
import pytest

from ntlink_tpu.device_map import DeviceMapper
from ntlink_tpu.host_map import HostMapper
from ntlink_tpu.index import ContigIndex
from ntlink_tpu.ops import nthash_np
from ntlink_tpu_torch.chain import CHAIN_MAX_CONTIGS
from ntlink_tpu_torch.device_map import TorchMapper

K, W = 32, 100


def _dataset(with_contigs=False):
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
    if with_contigs:
        return index, reads, contigs
    return index, reads


def _chimera(contigs):
    """A 39 kb read that switches between c0 and c1 every 300 bases, at
    the same offsets in both: each contig's anchors span less than the
    read, so no noisy-span drop, and its runs overflow RUN_LANES."""
    s, n = 10_000, 39_000
    read = contigs[0][s : s + n].copy()
    for a in range(300, n, 600):
        read[a : a + 300] = contigs[1][s + a : s + a + 300]
    return read


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
    # only the sub-k reads take the exact host path; N reads batch on the
    # device, in their own (pad, has N) buckets
    assert tm.host_fallbacks == 2
    assert tm.device_reads == len(reads) - 2
    assert any(has_n for _, has_n in tm.batches_by_pad)
    assert not tm.prechained and not tm.runs_only


def _same_runs(a, b):
    assert a[:2] == b[:2]
    ra, rb = a[2], b[2]
    assert (ra is None) == (rb is None), a[0]
    if ra is not None:
        assert ra[0] == rb[0], a[0]
        assert np.array_equal(ra[1], rb[1]), a[0]


@pytest.mark.parametrize("runs_only", [False, True])
def test_prechained_payloads_match_device_and_host(runs_only):
    """prechain=(contig lengths, z): the chaining acceptance runs in the
    step, and with runs_only the payload is chain.c's run rows. The
    16384-base read overflows a shrunk slot budget and the chimera read
    overflows RUN_LANES; both go to the exact host path, which applies
    chain.c, so every payload equals DeviceMapper's and HostMapper's."""
    index, reads, contigs = _dataset(with_contigs=True)
    reads = reads + [("chimera", _chimera(contigs))]
    prechain = (np.full(3, 150_000, np.int32), 1000)
    tm = TorchMapper(index, K, W, batch_bases=65536, device="cpu",
                     prechain=prechain, runs_only=runs_only)
    tm._slots_for = lambda L: 64 if L == 16384 else DeviceMapper._slots_for(
        tm, L
    )
    assert tm.prechained and tm.runs_only == runs_only
    got = _raws(tm, reads)
    dm = DeviceMapper(index, K, W, batch_bases=65536, use_mesh=False,
                      with_hashes=False, prechain=prechain,
                      runs_only=runs_only)
    hm = HostMapper(index, K, W, threads=1, prechain=prechain,
                    runs_only=runs_only)
    assert dm.runs_only == hm.runs_only == runs_only
    same = _same_runs if runs_only else _same
    for want in (_raws(dm, reads), _raws(hm, reads)):
        assert len(want) == len(got)
        for a, b in zip(got, want):
            same(a, b)
    assert sum(r[2] is not None for r in got) > 40
    # the chimera's alternation dooms both contigs (specific-mode subsume),
    # on the host as on the device
    assert got[-1][2] is None
    # sub-k (2) + the slot-overflow read + the run-lane-overflow chimera
    assert tm.host_fallbacks == 4
    assert tm.device_reads == len(reads) - 4


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


@pytest.mark.parametrize(
    "n_contigs", [CHAIN_MAX_CONTIGS, CHAIN_MAX_CONTIGS + 1]
)
def test_contig_gate_matches_device_mapper(n_contigs):
    """Past CHAIN_MAX_CONTIGS contigs neither mapper chains on the device,
    so `prechained` and the payload kind agree for every draft."""
    rng = np.random.default_rng(n_contigs)
    hashes = rng.integers(1, 2**63, n_contigs, dtype=np.uint64)
    index = ContigIndex.from_sketches(
        (f"c{i}", nthash_np.Minimizers(hashes[i : i + 1],
                                       np.zeros(1, np.int64),
                                       np.ones(1, bool)))
        for i in range(n_contigs)
    )
    prechain = (np.full(n_contigs, 5000, np.int32), 1000)
    tm = TorchMapper(index, K, W, device="cpu", prechain=prechain,
                     runs_only=True)
    dm = DeviceMapper(index, K, W, use_mesh=False, with_hashes=False,
                      prechain=prechain, runs_only=True)
    assert (tm.prechained, tm.runs_only) == (dm.prechained, dm.runs_only)
    assert tm.prechained == (n_contigs <= CHAIN_MAX_CONTIGS)
