"""On-device chaining of the port (`chain.chain_anchors_device`,
`chain.summarize_runs_device`) against the exact host chain, after
``tests/test_device_chain.py``: the keep mask equals that test's own oracle
(`_host_keep`, the reference-semantics chain of ``ntlink_tpu.mapping``) on
the hand-built structures the acceptance stages exist for (z-filtered
contigs, noisy spans, nested sightings that doom a contig, the
self-dooming triple sighting, runs that merge once a middle run drops) and
on random rows, and the run rows equal the port's native ``chain.c``. A
row with more than RUN_LANES runs is flagged and its keep wiped, for the
exact host path. Exact comparison everywhere."""
import numpy as np
import pytest
import torch

from ntlink_tpu.parallel.mesh import NOISY_ONEHOT_MAX
from ntlink_tpu_torch.chain import (
    RUN_LANES, chain_anchors_device, summarize_runs_device,
)
from ntlink_tpu_torch.native import chain_module

from test_device_chain import K, Z, _host_keep


def _planes(rows, S):
    B = len(rows)
    found = np.zeros((B, S), bool)
    cid = np.zeros((B, S), np.int32)
    cpos = np.zeros((B, S), np.int32)
    for b, (cids, cps) in enumerate(rows):
        n = len(cids)
        found[b, :n] = True
        cid[b, :n] = cids
        cpos[b, :n] = cps
    return found, cid, cpos


def _device_keep(rows, clen, read_lens, S=32):
    found, cid, cpos = _planes(rows, S)
    keep, overflow = chain_anchors_device(
        torch.from_numpy(found), torch.from_numpy(cid),
        torch.from_numpy(cpos),
        torch.from_numpy(np.asarray(read_lens, np.int32)),
        torch.from_numpy(np.asarray(clen, np.int32)), Z, K,
    )
    return keep.numpy(), overflow.numpy()


STRUCTURED = [
    # simple two-contig split
    ([0, 0, 1, 1], [10, 50, 5, 40]),
    # z filter drops contig 2 entirely
    ([0, 2, 2, 1], [10, 5, 40, 7]),
    # noisy span: contig 0 anchors 4000 apart on a 2000-base read
    ([0, 0, 1, 1], [10, 4500, 5, 40]),
    # subsume: c1 nested between two sightings of c0 -> c1 dooms
    ([0, 0, 1, 0, 3], [10, 50, 5, 90, 7]),
    # self-dooming triple sighting of c0 (middle occurrence between first
    # and last -> c0 itself doomed)
    ([0, 1, 0, 3, 0], [10, 5, 50, 7, 90]),
    # adjacent runs of same contig after a dropped middle run merge
    ([0, 2, 0, 1], [10, 5, 50, 7]),
    # single anchors only
    ([4], [123]),
]


def test_structured_cases():
    clen = np.array([5000, 5000, 500, 5000, 5000], np.int32)  # c2 fails z
    rl = 2000
    rows, expected = [], []
    for cids, cps in STRUCTURED:
        rpos = list(range(0, 10 * len(cids), 10))
        rows.append((np.asarray(cids, np.int32), np.asarray(cps, np.int32)))
        expected.append(_host_keep(cids, cps, rpos, rl, clen))
    keep, overflow = _device_keep(rows, clen, [rl] * len(rows))
    assert not overflow.any()
    for b, exp in enumerate(expected):
        assert np.array_equal(keep[b, : len(exp)], exp), (b, keep[b], exp)
        assert not keep[b, len(exp):].any()
    # the cases are not all trivial: some rows drop anchors, some keep all
    assert any(not e.all() for e in expected)
    assert any(e.all() for e in expected)


@pytest.mark.parametrize("seed,n_contigs,n_rows", [
    (11, 12, 64),
    # past the JAX function's one-hot bound (`NOISY_ONEHOT_MAX`): one
    # scatter form serves every contig count in the port
    (31, NOISY_ONEHOT_MAX + 72, 32),
], ids=["12-contigs", "past-onehot-bound"])
def test_random_parity(seed, n_contigs, n_rows):
    rng = np.random.default_rng(seed)
    clen = rng.integers(200, 8000, n_contigs).astype(np.int32)
    rows, expected, rls = [], [], []
    for _ in range(n_rows):
        n = int(rng.integers(1, 30))
        cids = rng.integers(0, n_contigs, n).astype(np.int32)
        cps = rng.integers(0, 6000, n).astype(np.int32)
        rl = int(rng.integers(500, 4000))
        rpos = np.sort(rng.integers(0, rl, n)).astype(np.int32)
        rows.append((cids, cps))
        rls.append(rl)
        expected.append(_host_keep(cids, cps, rpos.tolist(), rl, clen))
    keep, overflow = _device_keep(rows, clen, rls)
    assert not overflow.any()
    for b, exp in enumerate(expected):
        assert np.array_equal(keep[b, : len(exp)], exp), b


def test_runs_summary_parity():
    """The run rows (cid, merged anchor count, first and terminal anchor
    fields) equal the port's native chain.c over structured and random
    anchor sets, merges after a subsume included."""
    cm = chain_module()
    assert cm is not None
    rng = np.random.default_rng(23)
    clen = rng.integers(200, 8000, 12).astype(np.int32)
    chainer = cm.Chainer(clen, [f"c{i}" for i in range(len(clen))])

    cases = []
    structured = [
        ([0, 1, 0, 1, 0], [10, 5, 50, 9, 90]),      # c1/c0 self-dooming mix
        ([0, 3, 0, 1], [10, 5, 50, 7]),              # merge after doom
        ([5, 5, 5], [10, 30, 60]),                   # one run, count 3
    ]
    for cids, cps in structured:
        n = len(cids)
        cases.append((
            np.asarray(cids, np.int32), np.asarray(cps, np.int32),
            np.arange(0, 10 * n, 10, dtype=np.int32),
            rng.integers(0, 4, n).astype(np.int32), 2000,
        ))
    for _ in range(48):
        n = int(rng.integers(1, 30))
        rl = int(rng.integers(500, 4000))
        cases.append((
            rng.integers(0, 12, n).astype(np.int32),
            rng.integers(0, 6000, n).astype(np.int32),
            np.sort(rng.integers(0, rl, n)).astype(np.int32),
            rng.integers(0, 4, n).astype(np.int32),
            rl,
        ))

    B, S = len(cases), 32
    found, cid, cpos = _planes([(c[0], c[1]) for c in cases], S)
    rposw = np.zeros((B, S), np.int32)
    for b, (_, _, rps, sbs, _) in enumerate(cases):
        rposw[b, : len(rps)] = rps | (sbs << 29)
    rls = np.asarray([c[4] for c in cases], np.int32)
    t_cid, t_cpos = torch.from_numpy(cid), torch.from_numpy(cpos)
    keep, overflow = chain_anchors_device(
        torch.from_numpy(found), t_cid, t_cpos, torch.from_numpy(rls),
        torch.from_numpy(clen), Z, K,
    )
    assert not overflow.any()
    valid, r_cid, r_cnt, f_cpos, l_cpos, f_rw, l_rw = (
        a.numpy() for a in summarize_runs_device(
            keep, t_cid, t_cpos, torch.from_numpy(rposw))
    )

    offs = np.zeros(B + 1, np.int64)
    np.cumsum([len(c[0]) for c in cases], out=offs[1:])
    runs_b, ro_b, _, _ = chainer.chain_batch(
        *(np.concatenate([c[j] for c in cases]) for j in range(4)),
        offs, rls, None, K, Z, 0, 0.0, 0, 0,
    )
    rr = np.frombuffer(runs_b, np.int32).reshape(-1, 8)
    ro = np.frombuffer(ro_b, np.int32)
    for b in range(B):
        exp = rr[ro[b] : ro[b + 1]]
        nv = int(valid[b].sum())
        assert nv == exp.shape[0], (b, nv, exp)
        got = np.stack([
            r_cid[b, :nv], r_cnt[b, :nv],
            f_cpos[b, :nv], f_rw[b, :nv] & 0x1FFFFFFF,
            (f_rw[b, :nv] >> 29) & 3,
            l_cpos[b, :nv], l_rw[b, :nv] & 0x1FFFFFFF,
            (l_rw[b, :nv] >> 29) & 3,
        ], axis=1)
        assert np.array_equal(got, exp), (b, got, exp)


@pytest.mark.parametrize("extra", [0, 8])
def test_run_overflow_flags_row(extra):
    """One run per anchor, from two alternating contigs (the JAX test's
    row) and from distinct contigs: RUN_LANES runs chain on the device as
    the host does, RUN_LANES + 8 flag the row (host redo) and wipe its
    keep rather than chain it wrongly."""
    n = RUN_LANES + extra
    rows = [
        (np.array([i % 2 for i in range(n)], np.int32), np.full(n, 10,
                                                              np.int32)),
        (np.arange(n, dtype=np.int32), np.full(n, 10, np.int32)),
    ]
    clen = np.full(n, 5000, np.int32)
    keep, overflow = _device_keep(rows, clen, [2000, 2000], S=128)
    if extra:
        assert overflow.all()
        assert not keep.any()
        return
    assert not overflow.any()
    rpos = list(range(0, 10 * n, 10))
    for b, (cids, cps) in enumerate(rows):
        exp = _host_keep(cids.tolist(), cps.tolist(), rpos, 2000, clen)
        assert np.array_equal(keep[b, :n], exp), b
    assert keep[1, :n].all()
