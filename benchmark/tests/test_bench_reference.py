"""The plain reference on inputs small enough to check by hand."""
import numpy as np

from benchmark.reference import nthash, ntlink
from benchmark.reference.flow.mapping import AnchorHit
from benchmark.reference.flow.pairs import PairTally

M64 = (1 << 64) - 1


def srol(x: int, d: int) -> int:
    hi, lo = x >> 33, x & ((1 << 33) - 1)
    for _ in range(d):
        hi = ((hi << 1) | (hi >> 30)) & ((1 << 31) - 1)
        lo = ((lo << 1) | (lo >> 32)) & ((1 << 33) - 1)
    return (hi << 33) | lo


def kmer_by_definition(codes, k):
    seeds = [int(s) for s in nthash.SEEDS]
    fh = rh = 0
    for j in range(k):
        fh ^= srol(seeds[codes[j]], k - 1 - j)
        rh ^= srol(seeds[3 - codes[j]], j)
    return (fh + rh) & M64, fh <= rh


def test_hash_matches_the_definition():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 300).astype(np.uint8)
    for k in (5, 32):
        key, fwd, valid = nthash.kmer_keys(codes, k)
        assert valid.all()
        for i in (0, 1, 77, len(codes) - k):
            want_key, want_fwd = kmer_by_definition(codes[i:i + k], k)
            assert int(key[i]) == want_key and bool(fwd[i]) == want_fwd


def test_reverse_complement_has_the_same_key():
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, 64).astype(np.uint8)
    a, fa, _ = nthash.kmer_keys(codes, 32)
    b, fb, _ = nthash.kmer_keys(3 - codes[::-1], 32)
    assert np.array_equal(a, b[::-1])


def test_window_leftmost_minimum():
    keys = np.array([5, 3, 3, 7, 1, 9, 2], dtype=np.uint64)
    # windows [5 3 3] [3 3 7] [3 7 1] [7 1 9] [1 9 2]
    assert nthash.window_winners(keys, 3).tolist() == [1, 4]
    assert nthash.window_winners(keys, 3, dedup=False).tolist() == [
        1, 1, 4, 4, 4]
    assert nthash.window_winners(keys, 8).tolist() == []


def test_n_breaks_kmers_but_not_windows():
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, 400).astype(np.uint8)
    codes[200] = 4
    h, p, f = nthash.sketch(codes, 15, 10)
    assert not ((p > 200 - 15) & (p <= 200)).any()
    joined = nthash.sketch_many([codes, codes[:190]], 15, 10, threads=1)
    assert np.array_equal(joined[0][1], p)


def test_index_drops_every_repeated_minimizer():
    sk = [(np.array([5, 9, 7], np.uint64), np.array([0, 10, 20]),
           np.array([True, False, True])),
          (np.array([9, 11], np.uint64), np.array([3, 8]),
           np.array([True, True]))]
    idx = ntlink.Index(["a", "b"], sk)
    assert idx.keys.tolist() == [5, 7, 11]
    found, cid, pos, strand = idx.lookup(np.array([7, 9, 11, 12], np.uint64))
    assert found.tolist() == [True, False, True, False]
    assert cid[found].tolist() == [0, 1] and pos[found].tolist() == [20, 8]
    # the control's low bits: 9 and 9 collide as before, and 13 now
    # passes for 5
    low = ntlink.Index(["a", "b"], sk, key_bits=3)
    assert low.keys.tolist() == [3, 5, 7]
    assert idx.lookup(np.array([13], np.uint64))[0].tolist() == [False]
    assert low.lookup(np.array([13], np.uint64))[0].tolist() == [True]
    assert not ntlink.Index(["a", "b"], sk, key_bits=2).lookup(
        np.array([5], np.uint64))[0].any()


def test_read_maps_to_its_contigs_and_pairs_them():
    rng = np.random.default_rng(8)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    a, b = genome[:9000], genome[9500:]
    names = ["a", "b"]
    idx = ntlink.Index(names, nthash.sketch_many([a, b], 32, 100, threads=1))
    lengths = {"a": len(a), "b": len(b)}
    read = genome[6000:14000]
    runs = ntlink.map_read(read, idx, lengths, 32, 100, 1000)
    assert [r.contig for r in runs] == ["a", "b"]
    first, last = runs[0].hits[0], runs[1].hits[-1]
    assert first.ctg_pos - first.read_pos == 6000
    assert last.ctg_pos - last.read_pos == 6000 - 9500
    lines = ntlink.verbose_lines("r0", runs).decode().splitlines()
    assert lines[0].startswith(f"r0\ta\t{len(runs[0].hits)}\t")
    t = PairTally(lengths, 32, 10)
    t.add_read(ntlink.read_runs(lines), len(read))
    (pair, ev), = t.pairs.items()
    assert (pair.source, pair.source_ori, pair.target) == ("a", "+", "b")
    # the 500 b left out between the contigs, to within a window
    assert abs(ev.gap_estimates[0] - 500) <= 2 * 100 + 32
    assert runs[0].hits[0] == AnchorHit(runs[0].hits[0].mx, first.ctg_pos,
                                        "+" if first.ctg_strand == "+"
                                        else "-", first.read_pos,
                                        first.read_strand)
