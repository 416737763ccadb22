"""Contig minimizer index.

Globally deduplicated minimizer table (reference ntlink_pair.py:189-211):
a minimizer hash occurring at more than one (contig, position) anywhere in
the assembly is removed entirely. (Keep-first then drop-dups is equivalent
to keeping exactly the hashes with global multiplicity one.)

Array-backed: hashes/contig-ids/positions/strands in sorted numpy arrays so
building a human-scale index (tens of millions of entries) is vectorized
sort/unique work, lookups are binary search, and the device hash table is
built straight from the arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Tuple

import numpy as np

from .ops.nthash_np import Minimizers
from .tracing import GLOBAL as tracer


@dataclass(frozen=True)
class IndexedMinimizer:
    contig: str
    position: int
    strand: str


class ContigIndex:
    """Deduplicated hash -> (contig, position, strand) table."""

    def __init__(self):
        self._chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        self.contig_names: List[str] = []
        self._contig_ids: Dict[str, int] = {}
        self._finalized = False
        # finalized arrays (sorted by hash, dedup'd)
        self.hashes = np.zeros(0, dtype=np.uint64)
        self.contig_ids = np.zeros(0, dtype=np.int32)
        self.positions = np.zeros(0, dtype=np.int32)
        self.strands = np.zeros(0, dtype=bool)

    def _contig_id(self, contig: str) -> int:
        cid = self._contig_ids.get(contig)
        if cid is None:
            cid = len(self.contig_names)
            self._contig_ids[contig] = cid
            self.contig_names.append(contig)
        return cid

    # -- construction ------------------------------------------------------

    def add_sketch(self, contig: str, mins: Minimizers) -> None:
        cid = self._contig_id(contig)
        n = len(mins)
        self._chunks.append(
            (
                np.asarray(mins.hashes, dtype=np.uint64),
                np.full(n, cid, dtype=np.int32),
                np.asarray(mins.positions, dtype=np.int32),
                np.asarray(mins.forward, dtype=bool),
            )
        )
        self._finalized = False

    def add_tsv_entries(
        self, contig: str, entries: Iterable[Tuple[int, int, str]]
    ) -> None:
        rows = list(entries)
        cid = self._contig_id(contig)
        n = len(rows)
        h = np.fromiter((r[0] for r in rows), dtype=np.uint64, count=n)
        p = np.fromiter((r[1] for r in rows), dtype=np.int32, count=n)
        s = np.fromiter((r[2] == "+" for r in rows), dtype=bool, count=n)
        self._chunks.append((h, np.full(n, cid, dtype=np.int32), p, s))
        self._finalized = False

    def finalize(self) -> None:
        """Global dedup (keep hashes with multiplicity one), sort by hash."""
        if self._finalized:
            return
        if self._chunks:
            h = np.concatenate([c[0] for c in self._chunks])
            cid = np.concatenate([c[1] for c in self._chunks])
            pos = np.concatenate([c[2] for c in self._chunks])
            strand = np.concatenate([c[3] for c in self._chunks])
            order = np.argsort(h, kind="stable")
            h, cid, pos, strand = h[order], cid[order], pos[order], strand[order]
            # multiplicity-one mask over the sorted hashes
            uniq_left = np.ones(h.shape[0], dtype=bool)
            uniq_left[1:] = h[1:] != h[:-1]
            uniq_right = np.ones(h.shape[0], dtype=bool)
            uniq_right[:-1] = h[:-1] != h[1:]
            keep = uniq_left & uniq_right
            self.hashes = h[keep]
            self.contig_ids = cid[keep]
            self.positions = pos[keep]
            self.strands = strand[keep]
        self._chunks = []
        self._finalized = True

    # -- queries -----------------------------------------------------------

    def __len__(self) -> int:
        self.finalize()
        return int(self.hashes.shape[0])

    def _lookup(self, h) -> int:
        self.finalize()
        i = int(np.searchsorted(self.hashes, np.uint64(h)))
        if i < self.hashes.shape[0] and self.hashes[i] == np.uint64(h):
            return i
        return -1

    def __contains__(self, h) -> bool:
        return self._lookup(h) >= 0

    def get(self, h) -> IndexedMinimizer:
        i = self._lookup(h)
        if i < 0:
            raise KeyError(h)
        return IndexedMinimizer(
            self.contig_names[self.contig_ids[i]],
            int(self.positions[i]),
            "+" if self.strands[i] else "-",
        )

    def member_mask(self, hashes: np.ndarray) -> np.ndarray:
        """Vectorized membership for a uint64 hash array."""
        self.finalize()
        if self.hashes.shape[0] == 0:
            return np.zeros(hashes.shape, dtype=bool)
        pos = np.searchsorted(self.hashes, hashes)
        pos = np.minimum(pos, self.hashes.shape[0] - 1)
        return self.hashes[pos] == hashes

    def lookup_many(self, hashes: np.ndarray):
        """(found mask, contig_ids, positions, strands) for a hash array."""
        self.finalize()
        if self.hashes.shape[0] == 0:
            z = np.zeros(hashes.shape[0], dtype=np.int32)
            return np.zeros(hashes.shape[0], bool), z, z, z.astype(bool)
        pos = np.minimum(
            np.searchsorted(self.hashes, hashes), self.hashes.shape[0] - 1
        )
        found = self.hashes[pos] == hashes
        return found, self.contig_ids[pos], self.positions[pos], self.strands[pos]

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_tsv(cls, path: str) -> "ContigIndex":
        """Build from an indexlr-style contig TSV (hash:pos:strand).

        Parses natively when the C build is available (GIL-released,
        ~60 M entries in seconds vs minutes of per-token Python splits at
        human scale); the Python fallback is semantics-identical. Traced
        (v=1) as the spans index/read (the file read; the fallback reads
        as it parses), index/parse (the parse into per-contig chunks) and
        index/dedup (`finalize`)."""
        from .native import tsv_module

        idx = cls()
        tm = tsv_module()
        if tm is not None:
            with tracer.stage("index/read"):
                with open(path, "rb") as fh:
                    buf = fh.read()
            with tracer.stage("index/parse"):
                for name, n, hb, pb, sb in tm.parse_sketch(buf):
                    cid = idx._contig_id(name)
                    idx._chunks.append(
                        (
                            np.frombuffer(hb, np.uint64),
                            np.full(n, cid, dtype=np.int32),
                            np.frombuffer(pb, np.int32),
                            np.frombuffer(sb, np.uint8).astype(bool),
                        )
                    )
            idx._finalized = False
        else:
            with tracer.stage("index/parse"), open(path) as fh:
                for line in fh:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) < 2 or not parts[1]:
                        continue
                    entries = []
                    for token in parts[1].split(" "):
                        h, p, s = token.split(":")
                        entries.append((int(h), int(p), s))
                    idx.add_tsv_entries(parts[0], entries)
        with tracer.stage("index/dedup"):
            idx.finalize()
        return idx

    @classmethod
    def from_sketches(
        cls, named_sketches: Iterable[Tuple[str, Minimizers]]
    ) -> "ContigIndex":
        idx = cls()
        for contig, mins in named_sketches:
            idx.add_sketch(contig, mins)
        idx.finalize()
        return idx
