"""Per-read anchor chaining.

Reimplements the mapping-acceptance semantics of the reference's hot loop
(reference ntlink_utils.py:200-294, ntlink_pair.py:336-414) over structured
hit arrays:

1. keep anchors on contigs of length >= z,
2. drop "noisy" contigs whose anchored span on the contig exceeds what the
   read span allows (fudge factor x),
3. group remaining anchors (in read order) into per-contig runs,
4. mark runs subsumed (two modes: "specific" marks whole contigs nested
   between repeated sightings of another contig; "sensitive" marks only the
   runs strictly between two sightings),
5. drop subsumed runs and merge now-adjacent runs of the same contig.

The result is an ordered list of `ContigRun`s per read, each carrying its
anchor hits — the exact payload of a verbose_mapping.tsv row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Sequence, Tuple


class AnchorHit(NamedTuple):
    """One matched minimizer between a read and a contig."""

    mx: int            # minimizer hash (0 for synthesized checkpoint hits)
    ctg_pos: int
    ctg_strand: str
    read_pos: int
    read_strand: str


@dataclass
class ContigRun:
    """A maximal run of consecutive anchors to one contig along a read."""

    contig: str
    hits: List[AnchorHit]
    subsumed: bool = False

    @property
    def hit_count(self) -> int:
        return len(self.hits)

    @property
    def first_hit(self) -> AnchorHit:
        return self.hits[0]

    @property
    def terminal_hit(self) -> AnchorHit:
        return self.hits[-1]

    def hits_string(self) -> str:
        """Render hits in the verbose_mapping format (ntlink_pair.py:307-313)."""
        return " ".join(
            f"{h.ctg_pos}:{h.ctg_strand}_{h.read_pos}:{h.read_strand}"
            for h in self.hits
        )


class RunView:
    """Light run summary for the native chaining fast path: exposes exactly
    the attributes the pair tally consumes (pairs.PairTally._add)."""

    __slots__ = ("contig", "hit_count", "first_hit", "terminal_hit")

    def __init__(self, contig, hit_count, first_hit, terminal_hit):
        self.contig = contig
        self.hit_count = hit_count
        self.first_hit = first_hit
        self.terminal_hit = terminal_hit


def parse_hits_string(text: str) -> List[AnchorHit]:
    """Inverse of ContigRun.hits_string (reference ntlink_utils.py:296-305)."""
    hits = []
    for token in text.split(" "):
        ctg_part, read_part = token.split("_")
        cp, cs = ctg_part.split(":")
        rp, rs = read_part.split(":")
        hits.append(AnchorHit(0, int(cp), cs, int(rp), rs))
    return hits


def _noisy_contigs(
    per_contig: Dict[str, List[AnchorHit]], read_length: int, k: int, x: float
) -> set:
    """Contigs whose anchored contig-span outruns the read span (+fudge)."""
    noisy = set()
    for contig, hits in per_contig.items():
        if len(hits) < 2:
            continue
        lo = min(hits, key=lambda h: h.ctg_pos)
        hi = max(hits, key=lambda h: h.ctg_pos)
        span = abs(hi.ctg_pos - lo.ctg_pos)
        if x == 0:
            if span > read_length + k:
                noisy.add(contig)
        else:
            threshold = min(
                read_length + k, x * abs(hi.read_pos - lo.read_pos) + k
            )
            if span > threshold:
                noisy.add(contig)
    return noisy


def _mark_subsumed_specific(runs: List[ContigRun]) -> None:
    """Nested-contig marking (reference ntlink_utils.py:280-294)."""
    first_seen: Dict[str, int] = {}
    subsumed_contigs = set()
    for i, run in enumerate(runs):
        if run.contig in first_seen:
            for j in range(first_seen[run.contig] + 1, i):
                subsumed_contigs.add(runs[j].contig)
        else:
            first_seen[run.contig] = i
    for run in runs:
        if run.contig in subsumed_contigs:
            run.subsumed = True


def _mark_subsumed_sensitive(runs: List[ContigRun]) -> None:
    """Run-level marking between repeat sightings (ntlink_utils.py:271-278)."""
    occurrences: Dict[str, List[int]] = {}
    for i, run in enumerate(runs):
        occurrences.setdefault(run.contig, []).append(i)
    for indices in occurrences.values():
        for i, j in zip(indices, indices[1:]):
            for idx in range(i + 1, j):
                runs[idx].subsumed = True


def chain_read_hits(
    hits: Sequence[Tuple[str, AnchorHit]],
    read_length: int,
    contig_lengths: Dict[str, int],
    k: int,
    z: int,
    x: float = 0.0,
    sensitive: bool = False,
) -> List[ContigRun]:
    """Chain (contig, AnchorHit) pairs (in read order) into accepted runs."""
    kept: List[Tuple[str, AnchorHit]] = []
    per_contig: Dict[str, List[AnchorHit]] = {}
    for contig, hit in hits:
        if contig_lengths[contig] >= z:
            kept.append((contig, hit))
            per_contig.setdefault(contig, []).append(hit)

    noisy = _noisy_contigs(per_contig, read_length, k, x)
    if noisy:
        kept = [(c, h) for c, h in kept if c not in noisy]

    # group consecutive anchors by contig
    runs: List[ContigRun] = []
    for contig, hit in kept:
        if runs and runs[-1].contig == contig:
            runs[-1].hits.append(hit)
        else:
            runs.append(ContigRun(contig, [hit]))

    if sensitive:
        _mark_subsumed_sensitive(runs)
    else:
        _mark_subsumed_specific(runs)

    surviving = [r for r in runs if not r.subsumed]

    # merge adjacent runs of the same contig after subsume removal
    final: List[ContigRun] = []
    for run in surviving:
        if final and final[-1].contig == run.contig:
            final[-1].hits.extend(run.hits)
        else:
            final.append(ContigRun(run.contig, list(run.hits)))

    assert len({r.contig for r in final}) == len(final)
    return final


def apply_repeat_filter(
    mxs: List[Tuple[int, int, str]]
) -> List[Tuple[int, int, str]]:
    """Drop minimizers occurring multiple times within one read's filtered
    sketch (reference ntlink_pair.py:368-374)."""
    seen, dups = set(), set()
    for mx, _, _ in mxs:
        if mx in seen:
            dups.add(mx)
        else:
            seen.add(mx)
    if not dups:
        return mxs
    return [t for t in mxs if t[0] not in dups]
