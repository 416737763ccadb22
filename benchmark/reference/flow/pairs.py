"""Contig-pair evidence tally and scaffold graph construction.

Behavioral contract: reference ntlink_pair.py:157-334 (orientation/gap math,
pair normalization), :416-435 (transitive tally with f-cap), :241-255 (global
filters), :263-305 (doubled reverse-complement edge graph), :437-488
(checkpoint tally from a verbose_mapping file).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .mapping import AnchorHit, ContigRun, RunView


def flip_orientation(ori: str) -> str:
    return "-" if ori == "+" else "+"


@dataclass(frozen=True)
class PairKey:
    """A directed, oriented contig pair (normalized: smaller name first)."""

    source: str
    source_ori: str
    target: str
    target_ori: str

    @staticmethod
    def normalized(source, source_ori, target, target_ori) -> "PairKey":
        if source < target:
            return PairKey(source, source_ori, target, target_ori)
        return PairKey(
            target, flip_orientation(target_ori), source, flip_orientation(source_ori)
        )

    def reverse_complement(self) -> "PairKey":
        return PairKey(
            self.target,
            flip_orientation(self.target_ori),
            self.source,
            flip_orientation(self.source_ori),
        )

    @property
    def source_name(self) -> str:
        return self.source + self.source_ori

    @property
    def target_name(self) -> str:
        return self.target + self.target_ori


class PairEvidence:
    """Accumulated gap estimates + anchor support for one pair."""

    __slots__ = ("gap_estimates", "anchor")

    def __init__(self):
        self.gap_estimates: List[int] = []
        self.anchor = 0

    @property
    def n_supporting(self) -> int:
        return len(self.gap_estimates)

    def gap_estimate(self) -> int:
        # int() of numpy median: truncation toward zero, matching the
        # reference's determinism contract (ntlink_pair.py:73)
        return int(np.median(self.gap_estimates))

    def render(self) -> str:
        return (
            f"n={self.n_supporting}, gap_estimates={self.gap_estimates}, "
            f"anchor={self.anchor}"
        )


def _overhang(ori: str, pos: int, ctg_len: int, k: int, is_source: bool) -> int:
    if is_source:
        return ctg_len - pos - k if ori == "+" else pos
    return pos if ori == "+" else ctg_len - pos - k


def orient_and_gap(
    contig_i: str,
    hit_i: AnchorHit,
    contig_j: str,
    hit_j: AnchorHit,
    contig_lengths: Dict[str, int],
    k: int,
) -> Tuple[PairKey, int]:
    """Derive the normalized pair and gap estimate from two anchor hits.

    hit_i is the terminal anchor of the upstream run, hit_j the first anchor
    of the downstream run (read coordinates increasing).
    """
    assert hit_i.read_pos < hit_j.read_pos
    ori_i = "+" if hit_i.read_strand == hit_i.ctg_strand else "-"
    ori_j = "+" if hit_j.read_strand == hit_j.ctg_strand else "-"
    pair = PairKey.normalized(contig_i, ori_i, contig_j, ori_j)

    a = _overhang(ori_i, hit_i.ctg_pos, contig_lengths[contig_i], k, True)
    b = _overhang(ori_j, hit_j.ctg_pos, contig_lengths[contig_j], k, False)
    if a < 0 or b < 0:
        raise AssertionError(
            f"negative overhang for pair {contig_i}/{contig_j}: a={a} b={b}"
        )
    gap = (hit_j.read_pos - hit_i.read_pos) - a - b
    return pair, int(gap)


class PairTally:
    """Streaming pair-evidence accumulator over chained reads."""

    def __init__(self, contig_lengths: Dict[str, int], k: int, f_cap: int):
        self.pairs: Dict[PairKey, PairEvidence] = {}
        self.contig_lengths = contig_lengths
        self.k = k
        self.f_cap = f_cap

    def _add(
        self,
        run_i: ContigRun,
        run_j: ContigRun,
        read_length: int,
        check_added: Optional[set] = None,
    ) -> Optional[PairKey]:
        pair, gap = orient_and_gap(
            run_i.contig,
            run_i.terminal_hit,
            run_j.contig,
            run_j.first_hit,
            self.contig_lengths,
            self.k,
        )
        if abs(gap) > read_length:
            return None
        if check_added is not None and pair in check_added:
            return None
        ev = self.pairs.get(pair)
        if ev is None:
            ev = self.pairs[pair] = PairEvidence()
        ev.gap_estimates.append(gap)
        if run_i.hit_count > 1 and run_j.hit_count > 1:
            ev.anchor += 1
        return pair

    def add_read(self, runs: List[ContigRun], read_length: int) -> None:
        """Tally all pairs implied by one read's accepted runs."""
        if len(runs) <= self.f_cap:
            for i in range(len(runs)):
                for j in range(i + 1, len(runs)):
                    self._add(runs[i], runs[j], read_length)
        else:
            added = set()
            for run_i, run_j in zip(runs, runs[1:]):
                added.add(self._add(run_i, run_j, read_length))
            strong = [r for r in runs if r.hit_count > 1]
            for run_i, run_j in zip(strong, strong[1:]):
                self._add(run_i, run_j, read_length, check_added=added)

    # -- global filters (applied once all reads are tallied) ---------------

    def filter_distances(self) -> None:
        """Drop pairs whose gap estimate subsumes either contig."""
        kept = {}
        for pair, ev in self.pairs.items():
            est = ev.gap_estimate()
            if est <= -self.contig_lengths[pair.source] or est <= -self.contig_lengths[pair.target]:
                continue
            kept[pair] = ev
        self.pairs = kept

    def filter_weak_anchors(self, min_anchor: int) -> None:
        self.pairs = {
            pair: ev for pair, ev in self.pairs.items() if ev.anchor >= min_anchor
        }

    def write_pairs_tsv(self, path: str) -> None:
        with open(path, "w") as fh:
            for pair, ev in self.pairs.items():
                fh.write(f"{pair.source_name}\t{pair.target_name}\t{ev.render()}\n")


def tally_from_checkpoint(
    checkpoint_path: str,
    contig_lengths: Dict[str, int],
    k: int,
    f_cap: int,
) -> PairTally:
    """Rebuild the pair tally from a verbose_mapping checkpoint file
    (reference ntlink_pair.py:437-488), skipping sketching and matching.

    The tally consumes only each run's end anchors (PairTally._add reads
    contig / hit_count / first_hit / terminal_hit), so only the first and
    last hit token of every row are parsed — no per-anchor objects — and
    single-run reads (the vast majority) skip tallying entirely (zero
    pairs by construction). ~20x over full-hit parsing at assembly scale.
    """
    tally = PairTally(contig_lengths, k, f_cap)

    def parse_token(tok: str) -> AnchorHit:
        ctg_part, read_part = tok.split("_")
        cp, cs = ctg_part.split(":")
        rp, rs = read_part.split(":")
        return AnchorHit(0, int(cp), cs, int(rp), rs)

    def process(rows: List[Tuple[str, int, str]]) -> None:
        if len(rows) < 2:
            return
        max_read_pos = 0
        by_contig: Dict[str, RunView] = {}
        order: List[str] = []
        for contig, count, hits_text in rows:
            sp = hits_text.find(" ")
            if sp < 0:
                first = last = parse_token(hits_text)
            else:
                first = parse_token(hits_text[:sp])
                last = parse_token(hits_text[hits_text.rfind(" ") + 1 :])
            by_contig[contig] = RunView(contig, count, first, last)
            order.append(contig)
            max_read_pos = max(max_read_pos, first.read_pos, last.read_pos)
        tally.add_read([by_contig[c] for c in order], max_read_pos)

    current_read, rows = None, []
    with open(checkpoint_path) as fh:
        for line in fh:
            read_id, contig, count, hits_text = line.rstrip("\n").split("\t")
            if read_id != current_read:
                if current_read is not None:
                    process(rows)
                current_read, rows = read_id, []
            rows.append((contig, int(count), hits_text))
    if rows:
        process(rows)
    return tally
