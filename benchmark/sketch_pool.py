"""The reference's whole-draft sketch (`judge.draft_sketches`) over a pool
of processes, one a core of the host: the same `nthash.sketch_many` on
each contig, the contigs handed out longest first. The reference's
whole-array NumPy steps hold the interpreter lock part of the time, so on
threads a draft of gigabases takes minutes; processes do not share it.

The workers are spawned, not forked (the run's process has threads), and
read each contig from the draft's FASTA as ``gen.write_fasta`` laid it
out, at its offset. Each writes its contig's sketch to a file of its own
and sends back only its index.
"""
from __future__ import annotations

import multiprocessing
import os
from typing import List, Sequence

import numpy as np

from .reference import nthash


def _sketch_one(fasta: str, offset: int, length: int, k: int, w: int,
                out: str) -> None:
    text = np.fromfile(fasta, np.uint8, count=length, offset=offset)
    h, p, f = nthash.sketch_many([nthash.ASCII_CODES[text]], k, w,
                                 threads=1)[0]
    np.savez(out, h=h, p=p, f=f)


def draft_sketches(fasta: str, names: Sequence[str], lengths: Sequence[int],
                   k: int, w: int, workdir: str,
                   processes: int = 0) -> List[tuple]:
    """``nthash.sketch_many(seqs, k, w)`` of the contigs of `fasta`, written
    by ``gen.write_fasta`` from `names` and their `lengths`, contig for
    contig, over `processes` workers (default: one a core), through files
    in `workdir`."""
    heads = np.array([len(n) + 2 for n in names], dtype=np.int64)
    ends = np.cumsum(heads + np.asarray(lengths, np.int64) + 1)
    if int(ends[-1]) != os.path.getsize(fasta):
        raise ValueError(f"{fasta} is not laid out as its contigs")
    outs = [os.path.join(workdir, f"reference-sketch.{i}.npz")
            for i in range(len(names))]
    jobs = sorted(((fasta, int(e - n - 1), int(n), k, w, out)
                   for e, n, out in zip(ends, lengths, outs)),
                  key=lambda job: -job[2])
    with multiprocessing.get_context("spawn").Pool(
            processes or os.cpu_count() or 1) as pool:
        pool.starmap(_sketch_one, jobs, chunksize=1)
    sketches = []
    for out in outs:
        with np.load(out) as z:
            sketches.append((z["h"], z["p"], z["f"]))
        os.remove(out)
    return sketches
