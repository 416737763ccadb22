"""PAF-like mapping output.

Contract: reference ntlink_paf_output.py. Each accepted contig run is sorted
by (ctg_pos, read_pos); runs that are not monotonic in read position are
repaired — single outlier minimizers are dropped, larger inconsistencies split
the run into blocks — provided at least 75% of transitions agree on a
direction; otherwise the run is suppressed.
"""
from __future__ import annotations

from typing import Dict, List

from .mapping import AnchorHit, ContigRun


def _consistent(hits, increasing: bool, i1: int, i2: int, dups: set) -> bool:
    if hits[i1].ctg_pos in dups or hits[i2].ctg_pos in dups:
        return True
    if increasing:
        return hits[i1].read_pos <= hits[i2].read_pos
    return hits[i1].read_pos >= hits[i2].read_pos


def _repair_blocks(transitions, hits, dups, increasing: bool) -> List[List[AnchorHit]]:
    breaks, drops = set(), set()
    for i, ok in enumerate(transitions):
        if ok:
            continue
        if hits[i].ctg_pos in dups or hits[i + 1].ctg_pos in dups:
            continue
        if i + 2 >= len(transitions):
            breaks.add(i + 1)
        elif _consistent(hits, increasing, i, i + 2, dups):
            drops.add(i + 1)
        elif i > 0 and _consistent(hits, increasing, i - 1, i + 1, dups):
            drops.add(i)
        else:
            breaks.add(i + 1)
    if not breaks and not drops:
        return [hits]
    blocks, current = [], []
    for i, hit in enumerate(hits):
        if i in drops:
            continue
        if i in breaks:
            blocks.append(current)
            current = [hit]
        else:
            current.append(hit)
    blocks.append(current)
    return blocks


def split_mapping_blocks(
    sorted_hits: List[AnchorHit], min_consistent: float = 0.75
) -> List[List[AnchorHit]]:
    """Split/clean a (ctg_pos, read_pos)-sorted hit list into blocks."""
    seen_pos, dups = set(), set()
    incr, decr = [], []
    for a, b in zip(sorted_hits, sorted_hits[1:]):
        incr.append(a.read_pos <= b.read_pos)
        decr.append(a.read_pos >= b.read_pos)
        if a.ctg_pos in seen_pos:
            dups.add(a.ctg_pos)
        else:
            seen_pos.add(a.ctg_pos)
    if sorted_hits[-1].ctg_pos in seen_pos:
        dups.add(sorted_hits[-1].ctg_pos)

    if all(incr) or all(decr):
        return [sorted_hits]
    n_incr = sum(incr)
    if n_incr / len(incr) >= min_consistent:
        return _repair_blocks(incr, sorted_hits, dups, increasing=True)
    if (len(incr) - n_incr) / len(incr) >= min_consistent:
        return _repair_blocks(decr, sorted_hits, dups, increasing=False)
    return []


def paf_lines(
    runs: List[ContigRun],
    read_name: str,
    read_len: int,
    contig_lengths: Dict[str, int],
    k: int,
) -> List[str]:
    """Render one read's accepted runs as PAF-like lines."""
    lines = []
    for run in runs:
        ordered = sorted(run.hits, key=lambda h: (h.ctg_pos, h.read_pos))
        if run.hits == ordered or (
            sorted(ordered, key=lambda h: (h.ctg_pos, h.read_pos), reverse=True)
            == run.hits
        ):
            blocks = [ordered]
        else:
            blocks = split_mapping_blocks(ordered)
        for block in blocks:
            first, last = block[0], block[-1]
            n_same = sum(1 for h in block if h.ctg_strand == h.read_strand)
            strand = "+" if n_same / len(block) * 100 >= 50 else "-"
            t_start = min(first.ctg_pos, last.ctg_pos)
            t_end = max(first.ctg_pos, last.ctg_pos) + k
            q_start = min(first.read_pos, last.read_pos)
            q_end = max(first.read_pos, last.read_pos) + k
            assert 0 <= q_start < q_end <= read_len
            lines.append(
                f"{read_name}\t{read_len}\t{q_start}\t{q_end}\t{strand}\t"
                f"{run.contig}\t{contig_lengths[run.contig]}\t"
                f"{t_start}\t{t_end}\t{len(block)}\t{t_end - t_start}\t255"
            )
    return lines
