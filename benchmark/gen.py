"""Data of a cell, made from its configuration, its traffic mix and the
run's seed: a random genome with repeat families, a draft assembly cut
from it, and long reads drawn from it.

Sizes come from a generator of their own, seeded by the configuration and
the mix alone, so every seed gets the same contig lengths, repeat copies,
N runs and read lengths; the run's seed places them, orders them and
draws every base and every error. Everything is vectorised NumPy, written
once.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)
#: the quality line of every read (Phred 30)
QUAL = b"?"


def rng_for(seed: int, *stream: str) -> np.random.Generator:
    """A generator for one purpose of one run: the seed (any integer) and
    the names of the stream."""
    words = [seed % (1 << 64)] + [zlib.crc32(s.encode()) for s in stream]
    return np.random.default_rng(words)


def sizes_rng(*names: str) -> np.random.Generator:
    """The generator of sizes: the same for every seed."""
    return np.random.default_rng([zlib.crc32(n.encode()) for n in names])


def lognormal_lengths(rng, median: float, sigma: float, lo: int, hi: int,
                      total: int) -> np.ndarray:
    """Log-normal lengths in [lo, hi] (out-of-range draws drawn again)
    until their sum reaches `total`; the last one is cut to fit, or left
    out where that would put it under `lo`."""
    out: List[np.ndarray] = []
    have = 0
    while have < total:
        n = max(16, int(1.2 * (total - have) / median) + 16)
        x = rng.lognormal(np.log(median), sigma, n)
        x = np.floor(x[(x >= lo) & (x <= hi)]).astype(np.int64)
        out.append(x)
        have += int(x.sum())
    lengths = np.concatenate(out)
    cut = int(np.searchsorted(np.cumsum(lengths), total))
    lengths = lengths[: cut + 1].copy()
    lengths[-1] -= int(lengths.sum()) - total
    if lengths[-1] < lo:
        lengths = lengths[:-1]
    return lengths


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of ACGT codes (no N)."""
    return 3 - codes[::-1]


def mutate(codes: np.ndarray, rate: float, rng) -> None:
    """Substitute each base in place with probability `rate` by one of the
    three others."""
    step = 1 << 24
    for s in range(0, len(codes), step):
        part = codes[s:s + step]
        hit = np.nonzero(rng.random(len(part), dtype=np.float32) < rate)[0]
        part[hit] = (part[hit] + rng.integers(1, 4, len(hit),
                                              dtype=np.uint8)) % 4


def make_genome(cfg: dict, seed: int) -> np.ndarray:
    """The genome of a configuration: uniform random bases, and a share of
    it made of diverged copies of repeat families (`cfg["genome"]`)."""
    g = cfg["genome"]
    size = sizes_rng(cfg["name"], "genome")
    rng = rng_for(seed, cfg["name"], "genome")
    length = int(g["length"])
    genome = rng.integers(0, 4, length, dtype=np.uint8)
    fams = []
    copies = []          # (family, divergence)
    for group in g.get("repeats", []):
        lo, hi = group["family_length"]
        lens = np.exp(size.uniform(np.log(lo), np.log(hi),
                                   int(group["families"]))).astype(np.int64)
        base = len(fams)
        fams += [int(n) for n in lens]
        if "copies" in group:       # so many copies of every family
            picks = [base + f for f in range(len(lens))
                     for _ in range(int(group["copies"]))]
        else:                       # copies until they make up `share`
            picks, have = [], 0
            while have < group["share"] * length:
                picks.append(base + int(size.integers(0, len(lens))))
                have += fams[picks[-1]]
        copies += [(f, float(size.uniform(*group["divergence"])))
                   for f in picks]
    if not copies:
        return genome
    fam_len = np.asarray(fams, dtype=np.int64)
    fam_off = np.concatenate(([0], np.cumsum(fam_len)))
    fam_seq = rng.integers(0, 4, int(fam_off[-1]), dtype=np.uint8)
    copy_len = fam_len[[f for f, _ in copies]]
    free = length - int(copy_len.sum())
    if free < 0:
        raise ValueError("repeat copies longer than the genome")
    # gaps of unique sequence between copies: a fixed set, in seed order
    cuts = np.sort(size.integers(0, free + 1, len(copies)))
    gaps = np.diff(np.concatenate(([0], cuts)))
    order = rng.permutation(len(copies))
    gaps = rng.permutation(gaps)
    strands = rng.random(len(copies)) < 0.5
    pos = 0
    for j, i in enumerate(order):
        f, div = copies[i]
        pos += int(gaps[j])
        seq = fam_seq[fam_off[f]:fam_off[f + 1]].copy()
        if strands[j]:
            seq = revcomp(seq).copy()
        mutate(seq, div, rng)
        genome[pos:pos + len(seq)] = seq
        pos += len(seq)
    return genome


@dataclass
class Draft:
    names: List[str]
    seqs: List[np.ndarray]      # codes, 4 = N
    starts: np.ndarray          # genome offset of each contig

    @property
    def lengths(self) -> Dict[str, int]:
        return {n: len(s) for n, s in zip(self.names, self.seqs)}


def cut_draft(cfg: dict, genome: np.ndarray, seed: int) -> Draft:
    """Contigs tiling the genome in seed order, `gap` bases left out
    between neighbours, a share of them with one N run."""
    d = cfg["draft"]
    size = sizes_rng(cfg["name"], "draft")
    rng = rng_for(seed, cfg["name"], "draft")
    gap = int(d["gap"])
    sigma = float(d["sigma"])
    median = float(d["n50"]) / np.exp(sigma * sigma)
    # the contigs and their gaps fill the genome exactly
    lens = lognormal_lengths(size, median, sigma, int(d["min_length"]),
                             len(genome), len(genome))
    while len(lens) > 1 and int(lens.sum()) + gap * (len(lens) - 1) > len(
            genome):
        excess = int(lens.sum()) + gap * (len(lens) - 1) - len(genome)
        if lens[-1] - excess >= int(d["min_length"]):
            lens[-1] -= excess
        else:
            lens = lens[:-1]
    n_runs = int(round(d.get("n_run_share", 0.0) * len(lens)))
    run_lens = size.integers(d["n_run_length"][0], d["n_run_length"][1] + 1,
                             n_runs) if n_runs else np.zeros(0, np.int64)
    lens = rng.permutation(lens)
    starts = np.concatenate(([0], np.cumsum(lens[:-1] + gap)))
    seqs = [genome[s:s + n] for s, n in zip(starts, lens)]
    if n_runs:
        # the N runs go to contigs long enough to keep k-mers on both sides
        room = np.nonzero(lens >= 4 * int(run_lens.max()))[0]
        for c, rl in zip(rng.choice(room, n_runs, replace=False), run_lens):
            seq = seqs[c].copy()
            at = int(rng.integers(rl, len(seq) - 2 * rl))
            seq[at:at + rl] = 4
            seqs[c] = seq
    names = [f"ctg{i + 1}" for i in range(len(lens))]
    return Draft(names, seqs, starts)


def write_fasta(path: str, names: List[str], seqs: List[np.ndarray]) -> None:
    with open(path, "wb", buffering=1 << 24) as fh:
        for name, seq in zip(names, seqs):
            fh.write(b">" + name.encode() + b"\n")
            fh.write(ASCII[seq].tobytes())
            fh.write(b"\n")


@dataclass
class Reads:
    names: List[str]
    lengths: np.ndarray
    offsets: np.ndarray         # into `codes`
    codes: np.ndarray           # every read's bases, concatenated
    starts: np.ndarray          # genome offset
    reverse: np.ndarray

    def seq(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i]:self.offsets[i] + self.lengths[i]]

    @property
    def bases(self) -> int:
        return int(self.lengths.sum())


def read_lengths(profile: dict, total: int, *size_names: str) -> np.ndarray:
    """The read lengths of a mix: the same set for every seed."""
    return lognormal_lengths(sizes_rng(*size_names, "reads"),
                             float(profile["median"]),
                             float(profile["sigma"]), int(profile["min"]),
                             int(profile["max"]), int(total))


def make_reads(profile: dict, lengths: np.ndarray, genome: np.ndarray,
               seed: int, *stream: str, prefix: str = "r") -> Reads:
    """Reads of the given lengths, in seed order, drawn uniformly from the
    genome, half of them reverse-complemented, with substitutions."""
    rng = rng_for(seed, *stream, "reads")
    lengths = rng.permutation(np.minimum(lengths, len(genome)))
    starts = rng.integers(0, len(genome) - lengths + 1)
    reverse = rng.random(len(lengths)) < float(profile["reverse_share"])
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    codes = np.empty(int(lengths.sum()), dtype=np.uint8)
    for o, s, n, r in zip(offsets, starts, lengths, reverse):
        seq = genome[s:s + n]
        codes[o:o + n] = revcomp(seq) if r else seq
    mutate(codes, float(profile["substitution"]), rng)
    names = [f"{prefix}{i}" for i in range(len(lengths))]
    return Reads(names, lengths, offsets, codes, starts, reverse)


def write_fastq(path: str, reads: Reads) -> None:
    text = ASCII[reads.codes]
    qual = QUAL * int(reads.lengths.max())
    view = memoryview(text)
    with open(path, "wb", buffering=1 << 24) as fh:
        for name, o, n in zip(reads.names, reads.offsets, reads.lengths):
            fh.write(b"@" + name.encode() + b"\n")
            fh.write(view[o:o + n])
            fh.write(b"\n+\n")
            fh.write(qual[:n])
            fh.write(b"\n")
