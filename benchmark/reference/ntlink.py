"""ntLink's `pair` stage in plain NumPy and Python: the contig sketch, the
globally deduplicated minimizer index, each read's sketch, join and
chaining, the verbose mapping lines and the pair tally; and the whole
`scaffold` job through the frozen host stages of `flow`.

`key_bits` below 64 is the control (32 at the cells' sizes): the index is
keyed, and deduplicated, by the low bits of each hash alone, which breaks
the configuration's guarantee that minimizers match by their whole 64-bit
hash.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from . import nthash
from .flow.mapping import AnchorHit, ContigRun, RunView, chain_read_hits
from .flow.pairs import PairTally

def tsv_line(name: str, sk) -> bytes:
    """One line of the contig sketch TSV: name, tab, hash:pos:strand
    tokens separated by spaces."""
    h, p, f = sk
    body = " ".join(f"{a}:{b}:{'+' if c else '-'}"
                    for a, b, c in zip(h.tolist(), p.tolist(), f.tolist()))
    return f"{name}\t{body}\n".encode()


class Index:
    """Minimizers that occur once in the whole draft: sorted keys, with the
    contig, position and strand of each."""

    def __init__(self, names: Sequence[str], sketches, key_bits: int = 64):
        self.names = list(names)
        self.key_bits = key_bits
        h = np.concatenate([s[0] for s in sketches])
        cid = np.concatenate([np.full(len(s[0]), i, np.int32)
                              for i, s in enumerate(sketches)])
        pos = np.concatenate([s[1] for s in sketches]).astype(np.int64)
        strand = np.concatenate([s[2] for s in sketches])
        key = self.key(h)
        order = np.argsort(key, kind="stable")
        key = key[order]
        once = np.ones(len(key), dtype=bool)
        once[1:] &= key[1:] != key[:-1]
        once[:-1] &= key[:-1] != key[1:]
        sel = order[once]
        self.keys = key[once]
        self.cid, self.pos, self.strand = cid[sel], pos[sel], strand[sel]

    def key(self, h: np.ndarray) -> np.ndarray:
        if self.key_bits >= 64:
            return h
        return h & np.uint64((1 << self.key_bits) - 1)

    def lookup(self, h: np.ndarray):
        """(found, contig id, position, strand) for each hash."""
        k = self.key(h)
        if not len(self.keys):
            z = np.zeros(len(k), dtype=np.int64)
            return z.astype(bool), z, z, z.astype(bool)
        i = np.minimum(np.searchsorted(self.keys, k), len(self.keys) - 1)
        return self.keys[i] == k, self.cid[i], self.pos[i], self.strand[i]


def map_read(codes: np.ndarray, index: Index, lengths: Dict[str, int],
             k: int, w: int, z: int, sketch=None) -> List[ContigRun]:
    """The accepted runs of one read (ntLink's default mapping: no repeat
    filter, specific subsumption, x = 0); `sketch` is the read's, where the
    caller made it already."""
    h, p, f = sketch if sketch is not None else nthash.sketch(codes, k, w)
    found, cid, cpos, cstrand = index.lookup(h)
    names = index.names
    hits = [
        (names[c], AnchorHit(int(x), int(cp), "+" if cs else "-", int(rp),
                             "+" if rf else "-"))
        for x, rp, rf, c, cp, cs in zip(
            h[found].tolist(), p[found].tolist(), f[found].tolist(),
            cid[found].tolist(), cpos[found].tolist(),
            cstrand[found].tolist())
    ]
    if not hits:
        return []
    return chain_read_hits(hits, len(codes), lengths, k, z)


def verbose_lines(name: str, runs: List[ContigRun]) -> bytes:
    """A read's lines of the verbose mapping TSV."""
    return b"".join(
        f"{name}\t{r.contig}\t{r.hit_count}\t{r.hits_string()}\n".encode()
        for r in runs)


def _hit(token: str) -> AnchorHit:
    ctg, read = token.split("_")
    cp, cs = ctg.split(":")
    rp, rs = read.split(":")
    return AnchorHit(0, int(cp), cs, int(rp), rs)


def read_runs(lines: List[str]) -> List[RunView]:
    """A read's runs from its verbose lines: contig, count, first and last
    hit, as the tally reads them."""
    runs = []
    for line in lines:
        _, contig, count, text = line.split("\t")
        first = text[: text.find(" ")] if " " in text else text
        last = text[text.rfind(" ") + 1:]
        runs.append(RunView(contig, int(count), _hit(first), _hit(last)))
    return runs


def group_verbose(path: str) -> Dict[str, List[str]]:
    """The lines of a verbose mapping file by read, in file order."""
    out: Dict[str, List[str]] = {}
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            out.setdefault(line[: line.find("\t")], []).append(line)
    return out


def tally(by_read: Dict[str, List[str]], read_lengths: Dict[str, int],
          lengths: Dict[str, int], k: int, f: int) -> PairTally:
    """The pair tally of a mapping, read by read in file order, each with
    its true length."""
    t = PairTally(lengths, k, f)
    for name, lines in by_read.items():
        if len(lines) >= 2:
            t.add_read(read_runs(lines), read_lengths[name])
    return t


def tally_digest(t) -> Dict[tuple, tuple]:
    """A tally's pairs as plain tuples: (source, ori, target, ori) ->
    (gap estimates, anchor count)."""
    return {
        (p.source, p.source_ori, p.target, p.target_ori):
            (tuple(ev.gap_estimates), ev.anchor)
        for p, ev in t.pairs.items()
    }


def count_differing(a: dict, b: dict) -> int:
    """Keys present in one only, or with different values."""
    return sum(1 for key in set(a) | set(b) if a.get(key) != b.get(key))
