"""The comparisons that decide `correct`: the program's outputs against the
plain reference (`reference/`), on the sample of each run drawn from its
seed. Every number compared is a count of outputs that differ; each has
the limit 0.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Sequence

import numpy as np

from . import gen
from .reference import nthash, ntlink

THREADS = min(8, os.cpu_count() or 1)


def sample(n: int, size: int, seed: int, *stream: str,
           longest: Sequence[int] = ()) -> List[int]:
    """`size` indices of range(n) drawn from the seed, and `longest` with
    them, ascending."""
    rng = gen.rng_for(seed, "sample", *stream)
    pick = rng.choice(n, min(size, n), replace=False)
    return sorted(set(int(i) for i in pick) | set(int(i) for i in longest))


def file_digest(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def draft_sketches(draft, k: int, w: int):
    return nthash.sketch_many(draft.seqs, k, w, threads=THREADS)


def tsv_differing(path: str, draft, sketches, picks: Sequence[int]) -> int:
    """Contigs whose line of the program's sketch TSV differs from the
    reference's: every contig by its count of minimizers and its name, the
    sampled ones byte for byte."""
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    bad = abs(len(lines) - len(draft.names))
    for i, (name, line) in enumerate(zip(draft.names, lines)):
        head, _, body = line.partition(b"\t")
        n = body.count(b" ") + 1 if body else 0
        if head.decode() != name or n != len(sketches[i][0]):
            bad += 1
        elif i in picks and line + b"\n" != ntlink.tsv_line(name,
                                                            sketches[i]):
            bad += 1
    return bad


def reads_differing(program: Dict[str, List[str]], reads, picks, index,
                    lengths: Dict[str, int], k: int, w: int, z: int) -> int:
    """Sampled reads whose verbose mapping lines differ from the
    reference's (a read with no accepted run has none)."""
    bad = 0
    for i in picks:
        name = reads.names[i]
        want = ntlink.verbose_lines(
            name, ntlink.map_read(reads.seq(i), index, lengths, k, w, z))
        got = "".join(line + "\n" for line in program.get(name, []))
        bad += got.encode() != want
    return bad


def control_lines(reads, picks, index, lengths, k, w, z) -> Dict[str,
                                                               List[str]]:
    """The sampled reads' verbose lines as the control maps them (an index
    keyed below the configuration's guarantee)."""
    out = {}
    for i in picks:
        text = ntlink.verbose_lines(
            reads.names[i],
            ntlink.map_read(reads.seq(i), index, lengths, k, w, z)).decode()
        out[reads.names[i]] = text.splitlines()
    return out


def longest(lengths: np.ndarray, n: int) -> List[int]:
    return [int(i) for i in np.argsort(-lengths, kind="stable")[:n]]


def contig_picks(draft, seed: int) -> set:
    """The contigs whose TSV lines are compared byte for byte: 24 drawn
    from the seed, the 2 longest, and up to 8 with an N run."""
    with_n = [i for i, s in enumerate(draft.seqs) if (s > 3).any()][:8]
    lengths = np.array([len(s) for s in draft.seqs])
    return set(sample(len(draft.names), 24, seed, "contigs",
                      longest=longest(lengths, 2) + with_n))


def control_index(config: dict, draft, sketches) -> ntlink.Index:
    """The control's index: keyed by the low `control_key_bits` bits (32
    at the cells' sizes) of each hash."""
    return ntlink.Index(draft.names, sketches,
                        key_bits=int(config.get("control_key_bits", 32)))
