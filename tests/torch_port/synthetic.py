"""Synthetic drafts and reads for the port's end-to-end tests, made from a
seed, and the byte comparison of two runs' artifact directories."""
import filecmp
import os

import numpy as np

BASES = np.array(list("ACGT"))


def write_dataset(d, seed=11, n_reads=150, read_len=(3000, 20_000)):
    """A random genome cut into 4 contigs of 60 kb with 500 b gaps between
    them, and reads sampled across it with 3% substitutions, half
    reverse-complemented (tests/test_synthetic_truth.py:18-44, smaller),
    plus a sub-k read and an N-containing one. contig1 holds a run of 100
    N in its middle, so the reads that cross it carry N too. Writes
    target.fa and reads.fa into `d`."""
    rng = np.random.default_rng(seed)
    pieces, contigs = [], []
    for i in range(4):
        seq = "".join(BASES[rng.integers(0, 4, 60_000)])
        if i == 1:
            seq = seq[:30_000] + "N" * 100 + seq[30_100:]
        contigs.append((f"contig{i}", seq))
        pieces.append(seq)
        pieces.append("".join(BASES[rng.integers(0, 4, 500)]))
    genome = "".join(pieces)
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for r in range(n_reads):
        n = int(rng.integers(*read_len))
        start = int(rng.integers(0, len(genome) - n))
        arr = np.frombuffer(genome[start : start + n].encode(), np.uint8).copy()
        pos = rng.integers(0, n, n * 3 // 100)
        arr[pos] = BASES[rng.integers(0, 4, len(pos))].astype("S1").view(
            np.uint8
        )
        seq = arr.tobytes().decode()
        if rng.random() < 0.5:
            seq = seq.translate(comp)[::-1]
        reads.append((f"r{r}", seq))
    reads.append(("short", "ACGTTGCA"))
    reads.append(("with_n", reads[0][1][:4000] + "N" + reads[0][1][4001:]))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "target.fa"), "w") as fh:
        for name, seq in contigs:
            fh.write(f">{name}\n{seq}\n")
    with open(os.path.join(d, "reads.fa"), "w") as fh:
        for name, seq in reads:
            fh.write(f">{name}\n{seq}\n")


def write_rounds_dataset(d, seed=8, n_contigs=60, n_reads=120, err=0.12):
    """A draft that a second and a third round still join: a random genome
    cut into `n_contigs` contigs alternating 8-20 kb and 1-2 kb, with 500 b
    gaps between them, written to target.fa in shuffled order and
    orientation; `n_reads` reads of 8-30 kb sampled across the genome with
    `err` substitutions, half reverse-complemented, in reads.fa. The short
    contigs and the noisy reads leave joins for later rounds: on seed 8
    ``ntlink_tpu`` backend=numpy leaves 27 scaffolds after round 1, 23
    after round 2 and 22 after round 3 (k=32, w=100, z=1000)."""
    rng = np.random.default_rng(seed)
    comp = str.maketrans("ACGT", "TGCA")
    pieces, contigs = [], []
    for i in range(n_contigs):
        n = int(rng.integers(8000, 20_001) if i % 2 == 0
                else rng.integers(1000, 2001))
        seq = "".join(BASES[rng.integers(0, 4, n)])
        contigs.append(seq)
        pieces.append(seq)
        pieces.append("".join(BASES[rng.integers(0, 4, 500)]))
    genome = "".join(pieces)
    order = rng.permutation(n_contigs)
    flip = rng.random(n_contigs) < 0.5
    reads = []
    for r in range(n_reads):
        n = int(rng.integers(8000, 30_001))
        start = int(rng.integers(0, len(genome) - n))
        arr = np.frombuffer(genome[start : start + n].encode(), np.uint8).copy()
        pos = rng.integers(0, n, int(n * err))
        arr[pos] = BASES[rng.integers(0, 4, len(pos))].astype("S1").view(
            np.uint8
        )
        seq = arr.tobytes().decode()
        if rng.random() < 0.5:
            seq = seq.translate(comp)[::-1]
        reads.append((f"r{r}", seq))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "target.fa"), "w") as fh:
        for i in order:
            seq = contigs[i].translate(comp)[::-1] if flip[i] else contigs[i]
            fh.write(f">contig{i}\n{seq}\n")
    with open(os.path.join(d, "reads.fa"), "w") as fh:
        for name, seq in reads:
            fh.write(f">{name}\n{seq}\n")


def split_reads(d, n=2):
    """Split `d`/reads.fa round-robin by record into reads1.fa .. reads<n>.fa
    (multi-process runs shard by read file); returns the names."""
    names = [f"reads{i + 1}.fa" for i in range(n)]
    with open(os.path.join(d, "reads.fa")) as fh:
        lines = fh.read().splitlines()
    outs = [open(os.path.join(d, name), "w") for name in names]
    for r in range(len(lines) // 2):
        outs[r % n].write(lines[2 * r] + "\n" + lines[2 * r + 1] + "\n")
    for fh in outs:
        fh.close()
    os.remove(os.path.join(d, "reads.fa"))
    return names


def assert_same_tree(a, b, must_have=()):
    """Directories `a` and `b` hold the same names; symlinks point at the
    same names and regular files hold the same bytes. Every name in
    `must_have` is there and not empty. Returns the sorted names."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        assert os.path.islink(pa) == os.path.islink(pb), name
        if os.path.islink(pa):
            assert os.readlink(pa) == os.readlink(pb), name
        elif os.path.isfile(pa):
            assert filecmp.cmp(pa, pb, shallow=False), name
    for name in must_have:
        assert name in names, name
        assert os.path.getsize(os.path.join(a, name)) > 0, name
    return names
