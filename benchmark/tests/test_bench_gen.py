"""The generators: the same seed gives the same data, another seed other
data with the same sizes, and the data follows the mix's parameters."""
import numpy as np
import pytest

from benchmark import gen
from benchmark.tests.tiny import tiny_cell

SEED = 4_294_967_311  # past 32 bits


def data(kind, seed):
    cell = tiny_cell(kind)
    genome = gen.make_genome(cell.config, seed)
    draft = gen.cut_draft(cell.config, genome, seed)
    profile = cell.mix["reads"]
    lengths = gen.read_lengths(profile, 2_000_000, cell.config["name"],
                               cell.name)
    reads = gen.make_reads(profile, lengths, genome, seed, cell.name)
    return genome, draft, reads


@pytest.mark.parametrize("kind", ["stream", "job"])
def test_same_seed_same_data(kind):
    a, b = data(kind, SEED), data(kind, SEED)
    assert np.array_equal(a[0], b[0])
    assert a[1].names == b[1].names
    assert all(np.array_equal(x, y) for x, y in zip(a[1].seqs, b[1].seqs))
    assert np.array_equal(a[2].codes, b[2].codes)


def test_other_seed_same_sizes_other_data():
    (g1, d1, r1), (g2, d2, r2) = data("stream", SEED), data("stream", 7)
    assert not np.array_equal(g1, g2)
    assert sorted(map(len, d1.seqs)) == sorted(map(len, d2.seqs))
    assert sorted(r1.lengths) == sorted(r2.lengths)
    assert not np.array_equal(r1.lengths, r2.lengths)


def test_reads_follow_the_profile():
    genome, draft, reads = data("stream", SEED)
    p = tiny_cell("stream").mix["reads"]
    assert reads.lengths.min() >= p["min"] and reads.lengths.max() <= p["max"]
    assert 1_990_000 <= reads.bases <= 2_000_000
    med = np.median(reads.lengths)
    assert 0.7 * p["median"] < med < 1.3 * p["median"]
    assert 0.35 < reads.reverse.mean() < 0.65
    # substitutions against the genome, strand undone
    diff = n = 0
    for i in range(len(reads.names)):
        src = genome[reads.starts[i]:reads.starts[i] + reads.lengths[i]]
        seq = reads.seq(i)
        if reads.reverse[i]:
            seq = gen.revcomp(seq)
        diff += int((seq != src).sum())
        n += len(seq)
    assert abs(diff / n - p["substitution"]) < 0.003


def test_draft_tiles_the_genome():
    cell = tiny_cell("stream")
    genome, draft, _ = data("stream", SEED)
    gap = cell.config["draft"]["gap"]
    total = sum(map(len, draft.seqs)) + gap * (len(draft.seqs) - 1)
    assert total == len(genome)
    assert min(map(len, draft.seqs)) >= cell.config["draft"]["min_length"]
    with_n = [s for s in draft.seqs if (s > 3).any()]
    assert len(with_n) == round(cell.config["draft"]["n_run_share"]
                                * len(draft.seqs))
    for s, start in zip(draft.seqs, draft.starts):
        ok = s <= 3
        assert np.array_equal(s[ok], genome[start:start + len(s)][ok])


def test_repeat_copies_share_kmers():
    # copies of a family make the genome's 32-mers repeat far more than
    # uniform random bases would
    cell = tiny_cell("stream")
    genome = gen.make_genome(cell.config, SEED)
    words = np.lib.stride_tricks.sliding_window_view(genome, 16)[::7]
    packed = (words.astype(np.uint64)
              << (2 * np.arange(16, dtype=np.uint64))).sum(axis=1)
    _, counts = np.unique(packed, return_counts=True)
    assert (counts > 1).sum() > 100
