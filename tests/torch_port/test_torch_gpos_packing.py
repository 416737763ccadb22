"""Global-position packing of the hash-sharded index (`build_gpos_offsets`,
`decode_gpos`) against ntlink_tpu.parallel.mesh on both sides of the
uint32 span limit, and a sharded step whose index does not pack positions
against the replicated step, read by read. Comparisons are exact."""
import numpy as np
import pytest

from ntlink_tpu.parallel import mesh
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.index import ContigIndex
from ntlink_tpu_torch.ops import nthash_np
from ntlink_tpu_torch.ops.nthash_np import Minimizers
from ntlink_tpu_torch.parallel import sharded_index as port

K, W = 32, 100
TOP = 2**31 - 1  # the largest int32 position


def _entries(rng, tops, n_contigs):
    """(cid, pos): 600 random entries over `n_contigs` contigs below 2^20,
    and contig i's last entry at tops[i], so that the total span is
    sum(top + 1) plus at most 2^20 for each contig past len(tops)."""
    cid = rng.integers(0, n_contigs, 600).astype(np.int32)
    pos = rng.integers(0, 1 << 20, 600).astype(np.int32)
    cid = np.concatenate([cid, np.arange(len(tops), dtype=np.int32)])
    pos = np.concatenate([pos, np.asarray(tops, np.int32)])
    order = rng.permutation(len(cid))
    return cid[order], pos[order]


# two contigs whose spans sum to 0xFFFFFFFF - 1, 0xFFFFFFFF and
# 0xFFFFFFFF + 1
SPANS = {"below": (TOP, TOP - 2), "at": (TOP, TOP - 1), "above": (TOP, TOP)}


@pytest.mark.parametrize("side", sorted(SPANS))
def test_offsets_and_decode_equal_the_jax_package(side):
    rng = np.random.default_rng(41)
    cid, pos = _entries(rng, SPANS[side], 2)
    total = sum(int(t) + 1 for t in SPANS[side])
    offsets, pack, t_off = port.build_gpos_offsets(cid, pos, len(cid))
    r_offsets, r_pack, r_t_off = mesh.build_gpos_offsets(cid, pos, len(cid))
    assert int(offsets[-1]) == total
    assert pack == r_pack == (total <= 0xFFFFFFFF)
    assert pack == (side != "above")
    assert offsets.dtype == np.int64
    assert np.array_equal(offsets, r_offsets)
    if pack:
        assert t_off.dtype == np.uint32
        assert np.array_equal(t_off, np.asarray(r_t_off))
        # the packed plane of every entry decodes to its (cid, pos), in
        # both packages
        gplane = (t_off[cid].astype(np.int64) + pos).astype(
            np.uint32).view(np.int32)
        hashes = np.arange(1, len(cid) + 1, dtype=np.uint64)
        r_idx = mesh.DeviceIndex(hashes, cid, pos,
                                 np.zeros(len(cid), bool))
        sidx = port.ShardedDeviceIndex(hashes, cid, pos,
                                       np.zeros(len(cid), bool), 2)
        for got in (sidx.decode_gpos(gplane), r_idx.decode_gpos(gplane)):
            assert np.array_equal(got[0], cid)
            assert np.array_equal(got[1], pos)
    else:
        assert t_off is None and r_t_off is None


def test_gpos_offsets_with_all_six_contigs():
    """Six contigs, of which three have random spans only and contig 4 no
    entry at all (a zero span): the offsets of the JAX package."""
    rng = np.random.default_rng(42)
    cid, pos = _entries(rng, (TOP - 5, 7, 1 << 30), 6)
    keep = cid != 4
    cid, pos = cid[keep], pos[keep]
    offsets, pack, t_off = port.build_gpos_offsets(cid, pos, len(cid))
    r_offsets, r_pack, r_t_off = mesh.build_gpos_offsets(cid, pos, len(cid))
    assert np.array_equal(offsets, r_offsets) and pack == r_pack
    assert offsets[5] == offsets[4]
    g = np.arange(0, int(offsets[-1]), 7_919_999, dtype=np.int64).astype(
        np.uint32).view(np.int32)
    hashes = np.arange(1, len(cid) + 1, dtype=np.uint64)
    sidx = port.ShardedDeviceIndex(hashes, cid, pos, np.zeros(len(cid), bool),
                                   1)
    r_idx = mesh.DeviceIndex(hashes, cid, pos, np.zeros(len(cid), bool))
    for x, y in zip(sidx.decode_gpos(g), r_idx.decode_gpos(g)):
        assert np.array_equal(x, y)


@pytest.fixture(scope="module")
def contigs_and_reads():
    rng = np.random.default_rng(43)
    contigs = [rng.integers(0, 4, 30_000).astype(np.uint8) for _ in range(3)]
    reads = []
    for r in range(12):
        c = contigs[r % 3]
        start = int(rng.integers(0, len(c) - 9_000))
        read = c[start : start + int(rng.integers(2_000, 9_000))].copy()
        if r % 2:
            read = (3 - read)[::-1].copy()
        reads.append((f"r{r}", read))
    reads.append(("random", rng.integers(0, 4, 5_000).astype(np.uint8)))
    return contigs, reads


@pytest.mark.parametrize("shift", [0, TOP - 35_000])
def test_sharded_step_unpacked_equals_replicated(contigs_and_reads, shift):
    """Contigs 0 and 2 indexed at positions moved up by `shift`: at the
    largest shift their spans pass 0xFFFFFFFF together, the hash-sharded
    index ships (cid, cpos) as two planes, and every read's payload is
    the replicated index's, which holds the same positions."""
    contigs, reads = contigs_and_reads
    index = ContigIndex()
    for i, c in enumerate(contigs):
        m = nthash_np.sketch_codes(c, K, W)
        off = shift if i != 1 else 0
        index.add_sketch(f"c{i}", Minimizers(m.hashes, m.positions + off,
                                             m.forward))
    index.finalize()
    sharded = TorchMapper(index, K, W, devices=["cpu"] * 2,
                          index_sharding="hash", batch_bases=40_000)
    assert sharded.index_sharding == "hash"
    assert sharded.didx.pack_gpos == (shift == 0)
    replicated = TorchMapper(index, K, W, device="cpu", batch_bases=40_000)
    got = list(sharded.map_stream_raw(iter(reads)))
    want = list(replicated.map_stream_raw(iter(reads)))
    assert [g[:2] for g in got] == [w[:2] for w in want]
    n_hits = 0
    for g, w in zip(got, want):
        assert (g[2] is None) == (w[2] is None), g[0]
        if g[2] is None:
            continue
        n = g[2][0]
        assert n == w[2][0] > 0
        for x, y in zip(g[2][1:5], w[2][1:5]):
            assert np.array_equal(x[:n], y[:n]), g[0]
        n_hits += n
        if shift:
            cid, cpos = g[2][2][:n], g[2][3][:n]
            assert (cpos[cid != 1] >= shift).all()
    assert n_hits > 500
    assert sharded.host_fallbacks == replicated.host_fallbacks == 0
