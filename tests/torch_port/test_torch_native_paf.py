"""The port's native PAF rendering (its copy of ``native/chain.c``,
render_paf) against its Python `paf.py`, after ``tests/test_native_paf.py``:
byte for byte on adversarial hit patterns, across every branch (already
ascending and already descending runs, single-outlier repairs dropping
i+1 or i, block splits, duplicate contig positions, the <75% suppression),
in both chaining modes, and the PAF equal to ``ntlink_tpu``'s native
renderer's; then the port's vectorized repeat filter
(`pipeline._repeat_filter_batch`) against the per-read reference filter
and ``ntlink_tpu``'s batch filter."""
import numpy as np
import pytest

from ntlink_tpu.native import chain_module as ref_chain_module
from ntlink_tpu_torch.mapping import AnchorHit, chain_read_hits
from ntlink_tpu_torch.native import chain_module
from ntlink_tpu_torch.paf import paf_lines

K, Z = 32, 1000


def _expected_paf(per_read, read_lens, names, lengths, sensitive=False):
    out = b""
    for i, (cid, cpos, rpos, sbits) in enumerate(per_read):
        hits = [
            (
                names[c],
                AnchorHit(0, int(p), "+" if b & 1 else "-", int(r),
                          "+" if b & 2 else "-"),
            )
            for c, p, r, b in zip(cid, cpos, rpos, sbits)
        ]
        runs = chain_read_hits(
            hits, read_lens[i], lengths, k=K, z=Z, x=0.0, sensitive=sensitive
        )
        if not runs:
            continue
        for line in paf_lines(runs, f"read{i}", read_lens[i], lengths, K):
            out += (line + "\n").encode()
    return out


def _native_paf(chainer, per_read, read_lens, sensitive=False):
    n_reads = len(per_read)
    offs = np.zeros(n_reads + 1, np.int64)
    for i, (cid, _, _, _) in enumerate(per_read):
        offs[i + 1] = offs[i] + len(cid)
    cat = lambda j: (
        np.concatenate([p[j] for p in per_read]).astype(np.int32)
        if n_reads
        else np.zeros(0, np.int32)
    )
    rnames = [f"read{i}" for i in range(n_reads)]
    _, _, vbytes, pbytes = chainer.chain_batch(
        cat(0), cat(1), cat(2), cat(3), offs,
        np.asarray(read_lens, np.int32), rnames,
        K, Z, 1 if sensitive else 0, 0.0, 3,
    )
    assert vbytes is not None  # mode bit0 also requested
    return pbytes


def _mk_read(rng, kind, cid, read_len):
    """One single-contig read with a controlled (cpos, rpos) pattern."""
    m = int(rng.integers(3, 18))
    cpos = np.sort(rng.choice(read_len, size=m, replace=False)).astype(np.int32)
    base = np.sort(rng.choice(read_len - K, size=m, replace=False))
    if kind == "asc":
        rpos = base
    elif kind == "desc":
        rpos = base[::-1]
        cpos = cpos  # hits arrive in read order: rpos must ascend per sketch
    elif kind == "outlier":
        rpos = base.copy()
        j = int(rng.integers(1, m - 1))
        rpos[j] = rpos[j - 1] - 1 if rpos[j - 1] > 0 else rpos[j + 1] + 1
    elif kind == "split":
        half = m // 2
        rpos = np.concatenate([base[half:], base[:half]])
    elif kind == "noise":
        rpos = rng.permutation(base)
    elif kind == "dup":
        rpos = base.copy()
        cpos[m // 2] = cpos[m // 2 - 1]  # duplicated ctg_pos
    else:
        raise AssertionError(kind)
    # anchors stream in read order (ascending read_pos); re-sort rows so
    # rpos ascends while keeping the (cpos, rpos) pairing
    order = np.argsort(rpos, kind="stable")
    sbits = rng.integers(0, 4, size=m).astype(np.int32)
    return (
        np.full(m, cid, np.int32),
        cpos[order].astype(np.int32),
        rpos[order].astype(np.int32),
        sbits,
    )


@pytest.mark.parametrize("sensitive", [False, True])
def test_native_paf_matches_python(sensitive):
    mod = chain_module()
    assert mod is not None
    rng = np.random.default_rng(5 + int(sensitive))
    n_contigs = 5
    names = [f"ctg{i}" for i in range(n_contigs)]
    clen = rng.integers(3000, 9000, size=n_contigs).astype(np.int32)
    lengths = {names[i]: int(clen[i]) for i in range(n_contigs)}
    chainer = mod.Chainer(clen, names)

    kinds = ["asc", "desc", "outlier", "split", "noise", "dup"]
    per_read, read_lens = [], []
    for t in range(240):
        kind = kinds[t % len(kinds)]
        read_len = int(rng.integers(2000, 2800))
        per_read.append(_mk_read(rng, kind, t % n_contigs, read_len))
        read_lens.append(read_len)
    # multi-contig reads too (multiple runs per read)
    for t in range(40):
        read_len = 2600
        parts = [
            _mk_read(rng, kinds[(t + j) % len(kinds)], (t + j) % n_contigs,
                     read_len)
            for j in range(2)
        ]
        merged = tuple(np.concatenate([p[j] for p in parts]) for j in range(4))
        order = np.argsort(merged[2], kind="stable")
        per_read.append(tuple(a[order] for a in merged))
        read_lens.append(read_len)

    got = _native_paf(chainer, per_read, read_lens, sensitive)
    exp = _expected_paf(per_read, read_lens, names, lengths, sensitive)
    assert got == exp
    assert got.count(b"\n") > 200
    ref_chainer = ref_chain_module().Chainer(clen, names)
    assert _native_paf(ref_chainer, per_read, read_lens, sensitive) == got


def test_native_paf_handcrafted_branches():
    """Pin each repair branch with hand-built patterns (single contig)."""
    mod = chain_module()
    assert mod is not None
    names = ["c"]
    clen = np.asarray([10_000], np.int32)
    lengths = {"c": 10_000}
    chainer = mod.Chainer(clen, names)

    def run_case(cpos, rpos):
        m = len(cpos)
        per_read = [(
            np.zeros(m, np.int32),
            np.asarray(cpos, np.int32),
            np.asarray(rpos, np.int32),
            np.zeros(m, np.int32),
        )]
        got = _native_paf(chainer, per_read, [5000])
        exp = _expected_paf(per_read, [5000], names, lengths)
        assert got == exp
        return got

    # hits are given in read order (ascending read_pos); a jumbled ctg_pos
    # makes the (cpos, rpos)-ordered view non-monotonic in read_pos, which
    # is what drives the split/repair machinery.

    # drop-(i+1) repair: ordered read_pos [10,20,40,30,50,60] — the 30 is a
    # single outlier; repaired by dropping it, one block remains
    out = run_case([100, 200, 400, 300, 500, 600],
                   [10, 20, 30, 40, 50, 60])
    assert out.count(b"\n") == 1
    assert b"\t5\t" in out  # 5 hits survive in the block
    # drop-(i) repair: ordered read_pos [10,50,20,30,60] — the 50 is the
    # outlier (consistent(i,i+2) fails, consistent(i-1,i+1) holds)
    out = run_case([100, 300, 400, 200, 500], [10, 20, 30, 50, 60])
    assert out.count(b"\n") == 1
    # terminal break: ordered read_pos [10,20,30,40,60,50] fails only at
    # the last transition -> split into a 5-hit and a 1-hit block
    out = run_case([100, 200, 300, 400, 600, 500],
                   [10, 20, 30, 40, 50, 60])
    assert out.count(b"\n") == 2
    # suppression: ordered read_pos [10,5,30,3,50] agrees <75% both ways
    out = run_case([400, 200, 100, 300, 500], [3, 5, 10, 30, 50])
    assert out == b""
    # duplicate ctg_pos forgives the inconsistency: single block survives
    out = run_case([100, 200, 200, 300, 400], [10, 20, 5, 30, 40])
    assert out.count(b"\n") == 1


@pytest.mark.parametrize("n_empty", [0, 3])
def test_repeat_filter_batch_matches_python(n_empty):
    """Vectorized batch repeat filter == the per-read reference filter."""
    from ntlink_tpu.pipeline import _repeat_filter_batch as ref_filter
    from ntlink_tpu_torch.pipeline import _repeat_filter_batch

    rng = np.random.default_rng(17)
    n_reads = 60
    per_read = []
    for _ in range(n_reads):
        n = int(rng.integers(0, 25))
        hashes = rng.integers(0, 12, size=n).astype(np.uint64)  # many dups
        hashes |= hashes << np.uint64(32)
        per_read.append(hashes)
    for _ in range(n_empty):
        per_read.append(np.zeros(0, np.uint64))
    offs = np.zeros(len(per_read) + 1, np.int64)
    for i, h in enumerate(per_read):
        offs[i + 1] = offs[i] + len(h)
    allh = (
        np.concatenate(per_read)
        if len(per_read)
        else np.zeros(0, np.uint64)
    )
    hi = (allh >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (allh & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    payload = np.arange(len(allh), dtype=np.int32)

    new_offs, (kept,) = _repeat_filter_batch(offs, (payload,), hi, lo)
    ref_offs, (ref_kept,) = ref_filter(np, offs, (payload,), hi, lo)
    assert np.array_equal(new_offs, ref_offs)
    assert np.array_equal(kept, ref_kept)

    expect = []
    exp_offs = [0]
    for i, hashes in enumerate(per_read):
        counts = {}
        for h in hashes:
            counts[int(h)] = counts.get(int(h), 0) + 1
        keep = [
            int(offs[i]) + j
            for j, h in enumerate(hashes)
            if counts[int(h)] == 1
        ]
        expect.extend(keep)
        exp_offs.append(len(expect))
    assert kept.tolist() == expect
    assert new_offs.tolist() == exp_offs
