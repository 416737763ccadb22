"""The port's mapping step (ntlink_tpu_torch.mapping_step) against
ntlink_tpu.parallel.mesh: bucket table build, bucket join and the fused
step's per-read anchors. Inputs come from numpy seeds; comparisons are
exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntlink_tpu.index import ContigIndex
from ntlink_tpu.ops import nthash_np
from ntlink_tpu.parallel import mesh
from ntlink_tpu_torch import mapping_step as ms


def _entries(rng, n):
    hashes = np.unique(rng.integers(1, 2**64 - 1, n, dtype=np.uint64))
    m = len(hashes)
    return (
        hashes,
        (rng.integers(0, 50, m)).astype(np.int32),
        rng.integers(0, 1 << 20, m).astype(np.int32),
        rng.integers(0, 2, m).astype(bool),
    )


def _spilling_entries(rng):
    """Entries that all share one home bucket (the last one), so the spill
    chain wraps past the table end (cf. tests/test_bucket_join.py)."""
    pool = rng.integers(1, 2**63, 400_000, dtype=np.uint64)
    n_target = 3 * ms.BUCKET
    nb = 2
    while nb * ms.BUCKET_LOAD_SMALL < n_target:
        nb <<= 1
    lo = (pool & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (pool >> np.uint64(32)).astype(np.uint32)
    home = ((lo ^ hi) * np.uint32(ms._FIB)).astype(np.uint32) & np.uint32(nb - 1)
    hashes = np.unique(pool[home == nb - 1][:n_target])
    n = len(hashes)
    return (
        hashes, np.arange(n, dtype=np.int32) % 7,
        (np.arange(n, dtype=np.int32) * 13) % 1009, np.arange(n) % 2 == 1,
    )


@pytest.mark.parametrize("case", ["random", "spill"])
def test_device_index_matches_jax(case):
    rng = np.random.default_rng(21)
    ents = _entries(rng, 5000) if case == "random" else _spilling_entries(rng)
    jidx = mesh.DeviceIndex(*ents)
    t_bkt, bmask, probes = ms.DeviceIndex.build_table(*ents)
    assert np.array_equal(t_bkt, np.asarray(jidx.t_bkt))
    assert (bmask, probes) == (jidx.mask, jidx.max_probes)
    if case == "spill":
        assert probes >= 3


@pytest.mark.parametrize("case", ["random", "spill"])
def test_bucket_join_matches_jax(case):
    rng = np.random.default_rng(22)
    ents = _entries(rng, 5000) if case == "random" else _spilling_entries(rng)
    jidx = mesh.DeviceIndex(*ents)
    tidx = ms.DeviceIndex.from_numpy(
        np.asarray(jidx.t_bkt), jidx.mask, jidx.max_probes
    )
    present = ents[0]
    absent = rng.integers(0, 2**64 - 1, 3000, dtype=np.uint64, endpoint=True)
    absent = absent[~np.isin(absent, present)]
    q = np.concatenate([present, absent])
    jf, jc, jp, js = (
        np.asarray(a) for a in mesh.hash_bucket_join(
            jidx.t_bkt,
            jnp.asarray((q >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jidx.mask, jidx.max_probes,
        )
    )
    tf, tc, tp, ts = (
        a.numpy() for a in ms.hash_bucket_join(
            tidx.t_bkt, torch.from_numpy(q.view(np.int64)), tidx.mask,
            tidx.max_probes,
        )
    )
    assert np.array_equal(tf, jf)
    assert tf[: len(present)].all() and not tf[len(present):].any()
    assert np.array_equal(tc[tf], jc[jf])
    assert np.array_equal(tp[tf], jp[jf])
    assert np.array_equal(ts[tf], js[jf])
    assert (tc[~tf] == -1).all()


def test_select_minimizers_exact():
    rng = np.random.default_rng(23)
    emit = rng.random((16, 2048)) < 0.05
    emit[3] = True  # far over the slot budget
    emit[4] = False
    sel, ok, n_min = ms.select_minimizers(torch.from_numpy(emit), 64)
    for b in range(16):
        want = np.nonzero(emit[b])[0]
        assert int(n_min[b]) == len(want)
        got = sel[b][ok[b]].numpy()
        assert np.array_equal(got, want[:64]), b


def _decode_jax(out, B):
    flat = np.asarray(out["flat"])
    count, n_min = flat[0, :B], flat[0, B : 2 * B]
    if "r16" in out:
        v = np.asarray(out["r16"]).view(np.uint16).astype(np.int32)
        rpos, sbits = v & 0x3FFF, (v >> 14) & 3
        cid, cpos = flat[1], flat[2]
    else:
        rpos, sbits = flat[1] & 0x1FFFFFFF, (flat[1] >> 29) & 3
        cid, cpos = flat[2], flat[3]
    return count, n_min, rpos, sbits, cid, cpos


def _decode_torch(flat, B, S):
    flat = flat.numpy()
    count, n_min = flat[:B], flat[B : 2 * B]
    planes = flat[2 * B :].reshape(3, B * S)
    return (count, n_min, planes[0] & 0x1FFFFFFF, (planes[0] >> 29) & 3,
            planes[1], planes[2])


@pytest.mark.parametrize("L,S", [(4096, 128), (32768, 512), (4096, 64)])
def test_mapping_step_matches_jax(L, S):
    """Reads cut from indexed contigs (with substitutions, both strands)
    through both fused steps; the table is carried across with
    DeviceIndex.from_numpy. S=64 at L=4096 forces slot-overflow rows."""
    k, w, B = 32, 100, 8
    rng = np.random.default_rng(L + S)
    contigs = [rng.integers(0, 4, 60_000).astype(np.uint8) for _ in range(3)]
    index = ContigIndex.from_sketches(
        (f"c{i}", nthash_np.sketch_codes(c, k, w))
        for i, c in enumerate(contigs)
    )
    codes = np.zeros((B, L), np.uint8)
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lengths[0], lengths[1] = k + w - 2, 0
    for r in range(B):
        c = contigs[r % 3]
        s = int(rng.integers(0, len(c) - L))
        read = c[s : s + lengths[r]].copy()
        err = rng.random(len(read)) < 0.03
        read[err] = rng.integers(0, 4, err.sum())
        if r % 2:
            read = (3 - read)[::-1]
        codes[r, : len(read)] = read
    packed = ms.pack_codes(codes)
    assert np.array_equal(
        ms.unpack_codes(torch.from_numpy(packed), L).numpy(), codes
    )
    jidx = mesh.DeviceIndex.from_contig_index(index)
    out = mesh.mapping_step_packed(
        jnp.asarray(packed), jnp.asarray(lengths), jidx.t_bkt, k, w, L,
        jidx.mask, jidx.max_probes, S, use_pallas=False, with_hashes=False,
        t_off=None,
    )
    j = _decode_jax(out, B)
    tidx = ms.DeviceIndex.from_numpy(
        np.asarray(jidx.t_bkt), jidx.mask, jidx.max_probes
    )
    t = _decode_torch(
        ms.mapping_step(torch.from_numpy(packed), torch.from_numpy(lengths),
                        tidx, k, w, L, S),
        B, S,
    )
    j_offs = np.concatenate([[0], np.cumsum(j[0])])
    t_offs = np.concatenate([[0], np.cumsum(t[0])])
    n_over = 0
    for r in range(B):
        # rows over the slot budget go to the host path on both sides
        over = t[1][r] > S
        assert over == (j[1][r] > S), r
        n_over += int(over)
        if over:
            continue
        assert t[1][r] == j[1][r] and t[0][r] == j[0][r], r
        for tp, jp in zip(t[2:], j[2:]):
            assert np.array_equal(
                tp[t_offs[r] : t_offs[r + 1]], jp[j_offs[r] : j_offs[r + 1]]
            ), r
    assert t[0][2:].sum() > 0  # anchors were found
    if S == 64:
        assert n_over > 0
