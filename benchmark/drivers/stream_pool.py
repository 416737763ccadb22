"""Window of a read stream as ``stream.py`` runs it (its `setup`, `window`,
`release` and `check`), for a draft of gigabases, whose check as
``stream.py`` makes it would take minutes of each run. Two things differ
in the check, and neither compares less:

- the reference's whole-draft sketch is made by a pool of processes, one
  a core of the host (``sketch_pool``);
- the reference's index holds only the draft's minimizers whose keys the
  sampled reads hold, each with its count over the whole draft, so it
  answers every lookup the check makes as the whole index does; a lookup
  of any other key raises.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np

from benchmark import judge
from benchmark.drivers import stream
from benchmark.reference import nthash, ntlink
from benchmark.sketch_pool import draft_sketches

setup = stream.setup
window = stream.window
release = stream.release

#: low key bits of the bit table that screens keys before the exact test
SCREEN_BITS = 24


class SampledIndex(ntlink.Index):
    """``ntlink.Index`` over the minimizers whose keys are among those of
    `wanted` (hashes), with their counts over the whole of `sketches`."""

    def __init__(self, wanted: np.ndarray, names, sketches,
                 key_bits: int = 64):
        self.key_bits = key_bits
        self.wanted = np.unique(self.key(wanted))
        self.screen = np.zeros(1 << SCREEN_BITS, dtype=bool)
        self.screen[self._low(self.wanted)] = True
        kept = []
        for s in sketches:
            held = self.holds(s[0])
            kept.append(tuple(x[held] for x in s))
        super().__init__(names, kept, key_bits)

    @staticmethod
    def _low(k: np.ndarray) -> np.ndarray:
        return (k & np.uint64((1 << SCREEN_BITS) - 1)).astype(np.intp)

    def holds(self, h: np.ndarray) -> np.ndarray:
        """Whether each hash's key is among the wanted ones."""
        k = self.key(h)
        out = np.zeros(len(k), dtype=bool)
        maybe = np.flatnonzero(self.screen[self._low(k)])
        if len(maybe):
            sub = k[maybe]
            i = np.minimum(np.searchsorted(self.wanted, sub),
                           len(self.wanted) - 1)
            out[maybe] = self.wanted[i] == sub
        return out

    def lookup(self, h: np.ndarray):
        if not self.holds(h).all():
            raise ValueError("a lookup of a key no sampled read holds")
        return super().lookup(h)


def sampled_hashes(run, reads) -> np.ndarray:
    """The hashes of the reads ``stream.check`` samples."""
    cfg = run.config["ntlink"]
    picks = judge.sample(len(reads.names), int(run.mix["sample_reads"]),
                         run.seed, run.cell.name,
                         longest=judge.longest(reads.lengths, 5))
    return np.concatenate([np.zeros(0, np.uint64)] + [
        nthash.sketch(reads.seq(i), cfg["k"], cfg["w"])[0] for i in picks])


@contextlib.contextmanager
def swapped(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def check(run, st):
    draft, cfg = st["draft"], run.config["ntlink"]
    sketches = draft_sketches(run.path("target.fa"), draft.names,
                              [len(s) for s in draft.seqs], cfg["k"],
                              cfg["w"], run.workdir)
    index = functools.partial(SampledIndex, sampled_hashes(run, st["reads"]))
    with swapped(judge, "draft_sketches", lambda draft, k, w: sketches), \
            swapped(ntlink, "Index", index):
        return stream.check(run, st)
