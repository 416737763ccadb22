"""The port's bucket hash table (`mapping_step.DeviceIndex`,
`hash_bucket_join`) and minimizer selection (`select_minimizers`), after
``tests/test_bucket_join.py``: every entry is found and misses miss; spill
chains stay findable when every entry homes to one bucket at
BUCKET_LOAD_SMALL, the chain wrapping past the table's end; the selection
flags a row at exactly one minimizer past its slots and not at its slots;
and the selection equals the argsort reference. Exact comparison."""
import numpy as np
import torch

from ntlink_tpu.parallel.mesh import SELECT_BLOCK, SELECT_CAP
from ntlink_tpu_torch.mapping_step import (
    _FIB, BUCKET, BUCKET_LOAD_SMALL, DeviceIndex, hash_bucket_join,
    select_minimizers,
)


def _mkindex(hashes):
    n = len(hashes)
    return DeviceIndex.from_numpy(*DeviceIndex.build_table(
        np.asarray(hashes, np.uint64),
        np.arange(n, dtype=np.int32) % 7,
        (np.arange(n, dtype=np.int32) * 13) % 1009,
        (np.arange(n) % 2).astype(bool),
    ))


def _join(didx, hashes):
    h = torch.from_numpy(np.ascontiguousarray(hashes, np.uint64)
                         .view(np.int64))
    return tuple(t.numpy() for t in hash_bucket_join(
        didx.t_bkt, h, didx.mask, didx.max_probes))


def test_all_entries_found_and_misses_miss():
    rng = np.random.default_rng(3)
    hashes = np.unique(rng.integers(1, 2**63, 5000, dtype=np.uint64))
    didx = _mkindex(hashes)
    f, c, p, s = _join(didx, hashes)
    assert f.all()
    n = len(hashes)
    assert (c == np.arange(n) % 7).all()
    assert (p == (np.arange(n) * 13) % 1009).all()
    assert (s == (np.arange(n) % 2).astype(bool)).all()
    # misses: perturb the low word
    miss = hashes ^ np.uint64(0x5A5A5A5A)
    miss = miss[~np.isin(miss, hashes)]
    f2, c2, _, s2 = _join(didx, miss)
    assert not f2.any() and (c2 == -1).all() and not s2.any()


def test_bucket_spill_chains_stay_findable():
    """Every entry homes to the LAST bucket of a small (BUCKET_LOAD_SMALL)
    table: the spill chain must grow max_probes to 3 buckets, wrap to
    bucket 0, and every entry must still resolve."""
    rng = np.random.default_rng(4)
    pool = rng.integers(1, 2**63, 400_000, dtype=np.uint64)
    n_target = 3 * BUCKET  # needs a 3-bucket chain
    nb = 2
    while nb * BUCKET_LOAD_SMALL < n_target:
        nb <<= 1
    bmask = nb - 1
    lo = (pool & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (pool >> np.uint64(32)).astype(np.uint32)
    home = ((lo ^ hi) * np.uint32(_FIB)).astype(np.uint32) & np.uint32(bmask)
    picked = np.unique(pool[home == bmask][:n_target])
    assert len(picked) == n_target, "increase pool"
    didx = _mkindex(picked)
    assert didx.mask == bmask
    assert didx.max_probes >= 3
    # the chain wrapped: bucket 0 holds entries that home to the last one
    assert (didx.t_bkt[0, 2 * BUCKET : 3 * BUCKET] != 0).any()
    f, c, p, s = _join(didx, picked)
    assert f.all()
    n = len(picked)
    assert (c == np.arange(n) % 7).all()
    assert (p == (np.arange(n) * 13) % 1009).all()


def test_select_overflow_boundary():
    """Exactly `slots` minimizers: kept, not flagged. `slots` + 1: the row
    is flagged (n_minimizers > slots, the host maps it again) and only that
    row. The JAX function's per-block cap (SELECT_CAP emits in one block of
    SELECT_BLOCK windows, a TPU workaround) is not the port's: a row over
    that cap but within its slots is selected whole."""
    slots = 32
    NW = 16 * SELECT_BLOCK
    emit = np.zeros((4, NW), bool)
    emit[0, :slots] = True                          # exactly at slots
    emit[1, : slots + 1] = True                     # one over
    emit[2, :SELECT_CAP] = True                     # the JAX block cap
    emit[3, : SELECT_CAP + 1] = True                # one over it, in one block
    sel, ok, n_min = select_minimizers(torch.from_numpy(emit), slots)
    sel, ok, n_min = sel.numpy(), ok.numpy(), n_min.numpy()
    assert (n_min > slots).tolist() == [False, True, False, False]
    assert ok[0].sum() == slots and ok[1].sum() == slots
    for b in range(4):
        want = np.nonzero(emit[b])[0][:slots]
        assert np.array_equal(sel[b][ok[b]], want), b
        # order preservation: selected indices ascend (read order)
        assert (np.diff(sel[b][ok[b]]) > 0).all()


def test_select_matches_argsort_reference():
    rng = np.random.default_rng(5)
    B, NW, S = 16, 2048, 64
    emit = rng.random((B, NW)) < 0.02
    sel, ok, n_min = select_minimizers(torch.from_numpy(emit), S)
    sel, ok = sel.numpy(), ok.numpy()
    assert not (n_min > S).any()
    for b in range(B):
        want = np.nonzero(emit[b])[0][:S]
        assert np.array_equal(sel[b][ok[b]], want), b
