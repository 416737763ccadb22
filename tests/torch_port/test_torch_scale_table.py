"""The bucket table in the load-4 regime, which a human-size draft (~59 M
minimizers, past `SMALL_TABLE_ENTRIES`) takes, against
ntlink_tpu.parallel.mesh. The threshold is lowered in both packages (an
attribute set for the test only), so that 50,000 entries build at 4 of 8
slots a bucket; a share of the hashes is skewed onto a few home buckets,
so spill chains run several buckets long. Comparisons are exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntlink_tpu.parallel import mesh
from ntlink_tpu_torch import mapping_step as ms

N_ENTRIES = 50_000
SMALL = 1_000


@pytest.fixture
def load4(monkeypatch):
    monkeypatch.setattr(mesh, "SMALL_TABLE_ENTRIES", SMALL)
    monkeypatch.setattr(ms, "SMALL_TABLE_ENTRIES", SMALL)


def _home(hashes: np.ndarray, nb: int) -> np.ndarray:
    lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (hashes >> np.uint64(32)).astype(np.uint32)
    return ((lo ^ hi) * np.uint32(ms._FIB)).astype(np.uint32) & np.uint32(
        nb - 1)


def _skewed_entries(seed: int):
    """50,000 unique hashes: most spread evenly, 50 each homed on about 40
    buckets (so each of those chains spills over ~6 buckets, some into one
    another), in random order."""
    rng = np.random.default_rng(seed)
    nb = 2
    while nb * ms.BUCKET_LOAD < N_ENTRIES:
        nb <<= 1
    pool = np.unique(rng.integers(1, 2**64 - 1, 8_000_000, dtype=np.uint64))
    home = _home(pool, nb)
    # chains that wrap past the table's end, and two that meet
    hot = np.unique(np.concatenate([[nb - 1, nb - 2, 100, 101],
                                    rng.choice(nb, 36, replace=False)]))
    skewed = np.concatenate([pool[home == b][:50] for b in hot])
    rest = pool[~np.isin(home, hot)][: N_ENTRIES - len(skewed)]
    hashes = rng.permutation(np.concatenate([skewed, rest]))
    n = len(hashes)
    return (hashes, rng.integers(0, 750, n).astype(np.int32),
            rng.integers(0, 4_000_000, n).astype(np.int32),
            rng.integers(0, 2, n).astype(bool)), nb


@pytest.mark.parametrize("seed", [31, 32])
def test_load4_table_equals_the_jax_package(load4, seed):
    ents, nb = _skewed_entries(seed)
    jidx = mesh.DeviceIndex(*ents)
    t_bkt, bmask, probes = ms.DeviceIndex.build_table(*ents)
    assert len(ents[0]) > SMALL
    # the load-4 regime: a quarter as many buckets as entries
    assert t_bkt.shape == (nb, 4 * ms.BUCKET) and bmask == nb - 1
    assert (np.asarray(jidx.t_bkt).shape[0]) == nb
    assert t_bkt.dtype == np.uint32
    assert np.array_equal(t_bkt, np.asarray(jidx.t_bkt))
    assert (bmask, probes) == (jidx.mask, jidx.max_probes)
    assert probes >= 3
    # every entry is in the table once
    filled = (t_bkt[:, 2 * ms.BUCKET : 3 * ms.BUCKET] != 0).sum()
    assert filled == len(ents[0])


def test_load4_join_equals_the_jax_join(load4):
    ents, nb = _skewed_entries(33)
    hashes = ents[0]
    jidx = mesh.DeviceIndex(*ents)
    t_bkt, bmask, probes = ms.DeviceIndex.build_table(*ents)
    assert probes >= 3
    tidx = ms.DeviceIndex.from_numpy(t_bkt, bmask, probes)
    # entries that sit `probes - 1` buckets past their home: the ends of
    # the longest chains
    table_hash = (t_bkt[:, : ms.BUCKET].astype(np.uint64) << np.uint64(32)
                  | t_bkt[:, ms.BUCKET : 2 * ms.BUCKET].astype(np.uint64))
    occupied = t_bkt[:, 2 * ms.BUCKET : 3 * ms.BUCKET] != 0
    bucket = np.broadcast_to(np.arange(nb)[:, None], occupied.shape)
    where = table_hash[occupied]
    dist = (bucket[occupied] - _home(where, nb).astype(np.int64)) % nb
    chain_ends = where[dist == probes - 1]
    assert len(chain_ends) > 0
    rng = np.random.default_rng(34)
    absent = rng.integers(0, 2**64 - 1, 20_000, dtype=np.uint64,
                          endpoint=True)
    absent = absent[~np.isin(absent, hashes)]
    # absent hashes homed on the hot buckets: their probes cross the full
    # chains and find nothing
    hot_absent = rng.integers(1, 2**64 - 1, 2_000_000, dtype=np.uint64)
    hot_absent = hot_absent[np.isin(_home(hot_absent, nb),
                                    _home(chain_ends, nb))]
    hot_absent = hot_absent[~np.isin(hot_absent, hashes)][:500]
    assert len(hot_absent) > 100
    q = np.concatenate([hashes, chain_ends, absent, hot_absent])
    n_present = len(hashes) + len(chain_ends)
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
    assert tf[:n_present].all() and not tf[n_present:].any()
    # where the hash is found the answers are one entry's fields; where it
    # is not, mesh.hash_bucket_join leaves the first probed slot's fields
    # in cid / pos / strand, and the port answers cid -1
    assert np.array_equal(tc[tf], jc[jf])
    assert np.array_equal(tp[tf], jp[jf])
    assert np.array_equal(ts[tf], js[jf])
    assert (tc[~tf] == -1).all() and not ts[~tf].any()
    # and they are the index's own entries
    order = np.argsort(hashes)
    at = order[np.searchsorted(hashes, q[:n_present], sorter=order)]
    assert np.array_equal(tc[:n_present], ents[1][at])
    assert np.array_equal(tp[:n_present], ents[2][at])
    assert np.array_equal(ts[:n_present], ents[3][at])
