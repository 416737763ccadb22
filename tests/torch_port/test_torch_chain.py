"""The port's chaining acceptance and run summaries (ntlink_tpu_torch.chain)
against ntlink_tpu.parallel.mesh's `chain_anchors_device` and
`summarize_runs_device`, on the cases of tests/test_device_chain.py, and
against native chain.c where the JAX function's int32 run key cannot go
(more than 2^18 anchor lanes). Every value is an integer: exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntlink_tpu.native import chain_module
from ntlink_tpu.parallel import mesh
from ntlink_tpu_torch import chain

K, Z = 32, 1000


def _planes(rows, S, seed):
    """(found, cid, cpos, rposw) (B, S) planes: row b's anchors at lanes
    [0, n), with random read positions and strand bits."""
    rng = np.random.default_rng(seed)
    B = len(rows)
    found = np.zeros((B, S), bool)
    cid = np.zeros((B, S), np.int32)
    cpos = np.zeros((B, S), np.int32)
    rposw = np.zeros((B, S), np.int32)
    for b, (cids, cps) in enumerate(rows):
        n = len(cids)
        found[b, :n] = True
        cid[b, :n] = cids
        cpos[b, :n] = cps
        rposw[b, :n] = (np.sort(rng.integers(0, 4000, n))
                        | (rng.integers(0, 4, n) << 29))
    cid[~found] = -1
    return found, cid, cpos, rposw


def _structured():
    clen = np.array([5000, 5000, 500, 5000, 5000], np.int32)  # c2 fails z
    rows = [
        ([0, 0, 1, 1], [10, 50, 5, 40]),          # two-contig split
        ([0, 2, 2, 1], [10, 5, 40, 7]),           # z filter drops c2
        ([0, 0, 1, 1], [10, 4500, 5, 40]),        # noisy span on c0
        ([0, 0, 1, 0, 3], [10, 50, 5, 90, 7]),    # c1 nested in c0: doomed
        ([0, 1, 0, 3, 0], [10, 5, 50, 7, 90]),    # self-dooming triple
        ([0, 2, 0, 1], [10, 5, 50, 7]),           # merge after a dropped run
        ([0, 1, 0, 1, 0], [10, 5, 50, 9, 90]),
        ([4, 4, 4], [10, 30, 60]),                # one run, count 3
        ([4], [123]),                             # a single anchor
    ]
    return clen, rows, [2000] * len(rows), 32


def _random(nc, n_rows, seed):
    rng = np.random.default_rng(seed)
    clen = rng.integers(200, 8000, nc).astype(np.int32)
    rows, rls = [], []
    for _ in range(n_rows):
        n = int(rng.integers(1, 30))
        rows.append((rng.integers(0, nc, n), rng.integers(0, 6000, n)))
        rls.append(int(rng.integers(500, 4000)))
    return clen, rows, rls, 32


def _overflow():
    # alternating contigs: one run per anchor, past RUN_LANES in row 0
    n = chain.RUN_LANES + 8
    rows = [(np.arange(n) % 2, np.full(n, 10)),
            (np.arange(chain.RUN_LANES) % 2, np.full(chain.RUN_LANES, 10)),
            ([0, 0, 1], [10, 20, 30])]
    return np.array([5000, 5000], np.int32), rows, [2000] * 3, 128


CASES = {
    "structured": _structured,
    "random": lambda: _random(12, 64, 11),
    "large_nc": lambda: _random(mesh.NOISY_ONEHOT_MAX + 72, 32, 31),
    "run_overflow": _overflow,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_and_runs_match_jax(case):
    clen, rows, rls, S = CASES[case]()
    found, cid, cpos, rposw = _planes(rows, S, seed=len(rows))
    rls = np.asarray(rls, np.int32)
    j_keep, j_over = mesh.chain_anchors_device(
        jnp.asarray(found), jnp.asarray(cid), jnp.asarray(cpos),
        jnp.asarray(rls), jnp.asarray(clen), jnp.int32(Z), K,
    )
    t_keep, t_over = chain.chain_anchors_device(
        torch.from_numpy(found), torch.from_numpy(cid),
        torch.from_numpy(cpos), torch.from_numpy(rls),
        torch.from_numpy(clen), Z, K,
    )
    assert np.array_equal(t_keep.numpy(), np.asarray(j_keep))
    assert np.array_equal(t_over.numpy(), np.asarray(j_over))
    if case == "run_overflow":
        assert t_over.numpy().tolist() == [True, False, False]
    else:
        assert t_keep.any() and not t_over.any()
    j_runs = mesh.summarize_runs_device(
        j_keep, jnp.asarray(cid), jnp.asarray(cpos), jnp.asarray(rposw)
    )
    t_runs = chain.summarize_runs_device(
        t_keep, torch.from_numpy(cid), torch.from_numpy(cpos),
        torch.from_numpy(rposw),
    )
    for field, (t, j) in enumerate(zip(t_runs, j_runs)):
        assert t.dtype == (torch.bool if field == 0 else torch.int32)
        assert np.array_equal(t.numpy(), np.asarray(j)), field


def test_int64_lanes_match_chain_c():
    """2^19 anchor lanes, the kept anchors past lane 2^18: the JAX
    function's int32 key (lane << 13 | cid) wraps there; the port has no
    lane bound and selects exactly what chain.c's chain_select does."""
    cm = chain_module()
    assert cm is not None
    S = 1 << 19
    rng = np.random.default_rng(5)
    clen = np.array([5000, 5000, 500, 5000, 5000, 9000], np.int32)
    names = [f"c{i}" for i in range(len(clen))]
    rows = [
        [0, 0, 1, 1, 0, 3, 3, 5, 5, 5],   # c1 and c3 nested in c0
        [2, 4, 4, 1, 1, 5, 1],            # z drops c2; c5 inside c1
        [3] * 5 + [4] * 5,
    ]
    B = len(rows)
    found = np.zeros((B, S), bool)
    cid = np.full((B, S), -1, np.int32)
    cpos = np.zeros((B, S), np.int32)
    lanes = []
    for b, cids in enumerate(rows):
        ln = np.sort(rng.choice(np.arange(S - (1 << 16), S), len(cids),
                                replace=False))
        assert ln[0] > 1 << 18
        found[b, ln] = True
        cid[b, ln] = cids
        cpos[b, ln] = np.sort(rng.integers(0, 3000, len(cids)))
        lanes.append(ln)
    rls = np.full(B, 2000, np.int32)
    keep, over = chain.chain_anchors_device(
        torch.from_numpy(found), torch.from_numpy(cid),
        torch.from_numpy(cpos), torch.from_numpy(rls),
        torch.from_numpy(clen), Z, K,
    )
    assert not over.any()
    chainer = cm.Chainer(clen, names)
    for b, ln in enumerate(lanes):
        c = np.ascontiguousarray(cid[b, ln])
        sel = np.frombuffer(chainer.chain_select(
            c, np.ascontiguousarray(cpos[b, ln]),
            np.arange(len(ln), dtype=np.int32) * 10,
            np.zeros(len(ln), np.int32), int(rls[b]), K, Z, 0, 0.0,
        ), np.int32)
        assert np.array_equal(np.nonzero(keep[b].numpy())[0], ln[sel]), b
        assert len(sel) > 0
