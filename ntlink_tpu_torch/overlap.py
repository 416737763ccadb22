"""Overlap detection and trimming of adjacent joined scaffolds.

Behavioral contract: reference ntlink_filter_sequences.py +
ntlink_overlap_sequences.py (+ ntjoin_utils.filter_minimizers). For every
join whose estimated gap is negative (an overlap), re-sketch the flanking
regions at small (k, w), intersect the two contigs' ordered minimizer lists,
walk the strongest co-linear minimizer chain, and cut both sequences at its
middle minimizer. The three process boundaries of the reference
(filter | indexlr | overlap) collapse into one in-process pass over cached
sketches.

Determinism notes carried over from the reference: minimizer identifiers are
compared as *decimal strings* (endpoint choice and best-chain tie-breaks),
and medians go through numpy.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import ScaffoldConfig
from .graphio import ScaffoldGraph
from .ops import nthash_np
from .pathio import GAP_RE, is_gap, normalize_path_tokens, read_path_file
from .pipeline import log
from .seqio import stream_fastx

OVERLAP_FUDGE = 0.5  # reference -f default for the overlap stage


class TrimState:
    """Cut bookkeeping for one scaffold (reference ScaffoldCut:24-127)."""

    def __init__(self, ctg_id: str, length: int):
        self.ctg_id = ctg_id
        self.length = length
        self.ori: Optional[str] = None
        self.source_cut: Optional[int] = None
        self.target_cut: Optional[int] = None
        self._source_set = False
        self._target_set = False
        self.omitted = False

    def set_ori(self, ori: str) -> None:
        if self.ori is not None and self.ori != ori:
            raise AssertionError("Ori is already set")
        if self.ori is None:
            if ori == "+":
                self.target_cut, self.source_cut = 0, self.length
            else:
                self.target_cut, self.source_cut = self.length, 0
        self.ori = ori

    def set_source_cut(self, pos: int) -> None:
        if (self.ori == "+" and self.source_cut != self.length) or (
            self.ori == "-" and self.source_cut != 0
        ):
            raise AssertionError("Source cut is already set")
        self.source_cut = pos
        self._source_set = True

    def set_target_cut(self, pos: int) -> None:
        if (self.ori == "+" and self.target_cut != 0) or (
            self.ori == "-" and self.target_cut != self.length
        ):
            raise AssertionError("Target cut is already set")
        self.target_cut = pos
        self._target_set = True

    def adj_source_cut(self, k: int) -> int:
        if self.ori == "-" and self._source_set:
            return self.source_cut + k
        return self.source_cut

    def adj_target_cut(self, k: int) -> int:
        if self.ori == "-" and self._target_set:
            return self.target_cut + k
        return self.target_cut

    def both_cuts_set(self) -> bool:
        return self.source_cut is not None and self.target_cut is not None

    def valid_trims(self, k: int) -> bool:
        if self.ori == "+":
            return self.target_cut < self.source_cut
        if self.ori == "-":
            return self.adj_source_cut(k) < self.adj_target_cut(k)
        return True

    def trim_coordinates(self, k: int) -> Tuple[int, int]:
        if self.ori == "+":
            return self.target_cut, self.source_cut
        if self.ori == "-":
            return self.adj_source_cut(k), self.adj_target_cut(k)
        return 0, self.length


def valid_region(
    ctg: str, ori: str, lengths: Dict[str, int], overlap: int, k: int,
    fudge: float, is_source: bool
) -> Tuple[int, int]:
    """Flank window eligible for overlap minimizers
    (reference ntlink_utils.py:189-197); `overlap` is negative."""
    if (ori == "+" and is_source) or (ori == "-" and not is_source):
        start = (lengths[ctg] - (-overlap) - k) - int(-overlap * fudge)
        return start, lengths[ctg]
    return 0, int(-overlap * (fudge + 1))


def find_valid_regions(
    stitch_path_file: str,
    graph: ScaffoldGraph,
    lengths: Dict[str, int],
    g_min_gap: int,
    small_k: int,
) -> Dict[str, List[Tuple[int, int]]]:
    """Per-contig candidate flank windows for all overlap joins
    (reference ntlink_utils.py:146-175)."""
    regions: Dict[str, List[Tuple[int, int]]] = {}
    for _, tokens in read_path_file(stitch_path_file):
        tokens = normalize_path_tokens(tokens)
        for source, gap, target in zip(tokens, tokens[1:], tokens[2:]):
            m = GAP_RE.match(gap)
            if not m:
                continue
            if int(m.group(1)) <= g_min_gap + 1 and graph.has_edge(source, target) \
                    and graph.edge(source, target).d < 0:
                d = graph.edge(source, target).d
                s_name, t_name = source[:-1], target[:-1]
                regions.setdefault(s_name, []).append(
                    valid_region(s_name, source[-1], lengths, d, small_k,
                                 OVERLAP_FUDGE, True)
                )
                regions.setdefault(t_name, []).append(
                    valid_region(t_name, target[-1], lengths, d, small_k,
                                 OVERLAP_FUDGE, False)
                )
    return regions


def _in_regions(pos: int, regions: List[Tuple[int, int]]) -> bool:
    return any(start <= pos <= end for start, end in regions)


def region_minimizers(
    seq: str,
    regions: List[Tuple[int, int]],
    small_k: int,
    small_w: int,
) -> Tuple[Dict[str, int], List[str]]:
    """Sketch a contig and keep in-region minimizers, dropping in-region
    duplicates (reference read_minimizer_line:170-190). Returns
    (mx -> position, ordered mx list); mx ids are decimal strings to keep
    the reference's string-comparison tie-breaks."""
    mins = nthash_np.sketch_sequence(seq, small_k, small_w)
    info: Dict[str, int] = {}
    dups = set()
    order: List[Tuple[str, int]] = []
    for h, p in zip(mins.hashes.tolist(), mins.positions.tolist()):
        if not _in_regions(p, regions):
            continue
        mx = str(h)
        order.append((mx, p))
        if mx in info:
            dups.add(mx)
        else:
            info[mx] = p
    info = {mx: pos for mx, pos in info.items() if mx not in dups}
    ordered = [mx for mx, _ in order if mx in info]
    return info, ordered


def _intersect(lists: Dict[str, List[str]]) -> Dict[str, List[str]]:
    """Keep only minimizers present in both contigs (ntjoin_utils:18-32)."""
    sets = [set(v) for v in lists.values()]
    common = set.intersection(*sets)
    return {name: [mx for mx in v if mx in common] for name, v in lists.items()}


@dataclass
class ChainCandidate:
    mapped_region_length: float
    mid_mx: str
    median_length_from_end: float


def _dist_from_end(ori: str, pos: int, length: int, is_target: bool) -> int:
    if (ori == "+" and not is_target) or (ori == "-" and is_target):
        return -(length - pos)
    return -pos


def _print_mx_graph(
    out_path: str,
    nodes: List[str],
    adj: Dict[str, Dict[str, int]],
    info: Dict[str, Dict[str, int]],
    pair_names: List[str],
) -> None:
    """Append one pair's minimizer graph in the reference's verbose DOT
    dialect (ntlink_overlap_sequences.py:204-244): node labels carry the
    (contig, position) sightings, edges the adjacency weight; post-filter
    every edge has both contigs' support, so the colour is lightgrey."""
    colours = ["red", "green", "blue", "purple", "orange",
               "turquoise", "pink", "yellow", "orchid", "salmon"]
    with open(out_path, "a") as fh:
        fh.write("graph G {\n")
        for node in nodes:
            sightings = "\n".join(
                str((name, info[name][node]))
                for name in pair_names
                if node in info[name]
            )
            fh.write(f'"{node}" [label="{node}\n{sightings}"]\n')
        done = set()
        for a in nodes:
            for b, weight in adj[a].items():
                if (b, a) in done:
                    continue
                done.add((a, b))
                fh.write(f'"{a}" -- "{b}" [weight={weight} color=lightgrey]\n')
        fh.write("}\n")
    print("\nfile_name\tnumber\tcolour")
    for i, name in enumerate(pair_names):
        print(name, i, colours[i % len(colours)], sep="\t")
    print("")


def find_overlap_cuts(
    mxs: Dict[str, List[str]],
    info: Dict[str, Dict[str, int]],
    source: str,
    target: str,
    trims: Dict[str, TrimState],
    lengths: Dict[str, int],
    overlap_d: int,
    small_k: int,
    mx_dot: Optional[str] = None,
) -> bool:
    """Choose cut points for one overlapping join
    (reference merge_overlapping:341-417). Returns True when cuts are set."""
    s_name, s_ori = source[:-1], source[-1]
    t_name, t_ori = target[:-1], target[-1]

    # restrict to this join's flank windows, then intersect
    s_lo, s_hi = valid_region(s_name, s_ori, lengths, overlap_d, small_k,
                              OVERLAP_FUDGE, True)
    t_lo, t_hi = valid_region(t_name, t_ori, lengths, overlap_d, small_k,
                              OVERLAP_FUDGE, False)
    pair_lists = {
        s_name: [mx for mx in mxs[s_name] if s_lo <= info[s_name][mx] <= s_hi],
        t_name: [mx for mx in mxs[t_name] if t_lo <= info[t_name][mx] <= t_hi],
    }
    pair_lists = _intersect(pair_lists)

    # adjacency graph: undirected, weight = #contigs supporting the link
    adj: Dict[str, Dict[str, int]] = {}
    nodes: List[str] = []
    seen_nodes = set()

    def touch(n: str) -> None:
        if n not in seen_nodes:
            seen_nodes.add(n)
            nodes.append(n)
            adj[n] = {}

    for mx_list in pair_lists.values():
        for a, b in zip(mx_list, mx_list[1:]):
            touch(a)
            touch(b)
            adj[a][b] = adj[a].get(b, 0) + 1
            adj[b][a] = adj[b].get(a, 0) + 1
        if mx_list:
            touch(mx_list[-1])

    # drop weakly-supported links (weight < 2)
    for a in adj:
        for b in [b for b, w in adj[a].items() if w < 2]:
            del adj[a][b]

    if mx_dot:
        _print_mx_graph(mx_dot, nodes, adj, info, [s_name, t_name])

    # connected components
    comp_of: Dict[str, int] = {}
    components: List[List[str]] = []
    for start in nodes:
        if start in comp_of:
            continue
        comp, stack = [], [start]
        comp_of[start] = len(components)
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in adj[u]:
                if v not in comp_of:
                    comp_of[v] = len(components)
                    stack.append(v)
        components.append(comp)

    candidates: List[ChainCandidate] = []
    for comp in components:
        endpoints = [n for n in comp if len(adj[n]) == 1]
        singletons = [n for n in comp if len(adj[n]) == 0]
        if len(endpoints) == 2:
            a, b = endpoints
            if a > b:  # string comparison, as in the reference
                a, b = b, a
            # BFS shortest path a -> b (reference uses get_shortest_paths,
            # which tolerates branched interiors)
            prev_of = {a: None}
            frontier = [a]
            while frontier and b not in prev_of:
                nxt = []
                for u in frontier:
                    for v in adj[u]:
                        if v not in prev_of:
                            prev_of[v] = u
                            nxt.append(v)
                frontier = nxt
            if b not in prev_of:
                continue
            chain = [b]
            while prev_of[chain[-1]] is not None:
                chain.append(prev_of[chain[-1]])
            chain.reverse()
            start_mx, end_mx = chain[0], chain[-1]
            s_align = abs(info[s_name][start_mx] - info[s_name][end_mx])
            t_align = abs(info[t_name][start_mx] - info[t_name][end_mx])
            mid_mx = chain[len(chain) // 2]
            d_src = _dist_from_end(s_ori, info[s_name][mid_mx], lengths[s_name], False)
            d_tgt = _dist_from_end(t_ori, info[t_name][mid_mx], lengths[t_name], True)
            candidates.append(
                ChainCandidate(
                    float(np.median([s_align, t_align])),
                    mid_mx,
                    float(np.median([d_src, d_tgt])),
                )
            )
        elif singletons:
            assert len(singletons) == 1
            mid_mx = singletons[0]
            d_src = _dist_from_end(s_ori, info[s_name][mid_mx], lengths[s_name], False)
            d_tgt = _dist_from_end(t_ori, info[t_name][mid_mx], lengths[t_name], True)
            candidates.append(
                ChainCandidate(1, mid_mx, float(np.median([d_src, d_tgt])))
            )

    if not candidates:
        return False
    best = sorted(
        candidates,
        key=lambda c: (c.mapped_region_length, c.median_length_from_end, c.mid_mx),
        reverse=True,
    )[0]
    source_cut = info[s_name][best.mid_mx]
    target_cut = info[t_name][best.mid_mx]
    trims[s_name].set_ori(s_ori)
    trims[s_name].set_source_cut(source_cut)
    trims[t_name].set_ori(t_ori)
    trims[t_name].set_target_cut(target_cut)
    return True


def repair_invalid_trims(
    tokens: List[str], trims: Dict[str, TrimState], g_min_gap: int, small_k: int
) -> List[str]:
    """Drop scaffolds whose two cuts contradict, restoring a default gap
    (reference check_valid_overlap_trims:419-444)."""
    out: List[str] = []
    skip_gap = False
    for tok in tokens:
        if is_gap(tok):
            if not skip_gap:
                out.append(tok)
            skip_gap = False
            continue
        state = trims[tok[:-1]]
        if state.both_cuts_set() and not state.valid_trims(small_k):
            assert is_gap(out[-1])
            out[-1] = f"{g_min_gap + 1}N"
            skip_gap = True
            state.omitted = True
        else:
            out.append(tok)
    return out


def overlap_stage(
    cfg: ScaffoldConfig, dot_path: str, stitch_path_file: str
) -> str:
    """Run the overlap trim stage; returns the trimmed scaffolds FASTA path.

    Writes the reference's artifact set: trimmed_scafs.{path,fa,tsv,agp}
    (reference ntLink:246-251 + ntlink_overlap_sequences.py main).
    """
    from .graphio import read_dot

    log("Assessing putative overlaps...")
    prefix = cfg.resolved_prefix()
    graph = read_dot(dot_path)

    # streaming contract (reference bin/ntlink_filter_sequences.py:17-42):
    # the stage never holds the whole assembly — pass 1 records lengths,
    # pass 2 sketches only the contigs with overlap regions, pass 3 writes
    # the trimmed FASTA record by record. Peak RSS is O(largest contig),
    # independent of assembly size.
    trims: Dict[str, TrimState] = {}
    lengths: Dict[str, int] = {}
    for rec in stream_fastx(cfg.target):
        lengths[rec.name] = len(rec.seq)
        trims[rec.name] = TrimState(rec.name, len(rec.seq))

    regions = find_valid_regions(
        stitch_path_file, graph, lengths, cfg.g, cfg.small_k
    )

    # per-contig region-restricted sketches (k=small_k, w=small_w) — only
    # for contigs flanking a trimmable gap
    mx_info: Dict[str, Dict[str, int]] = {}
    mx_lists: Dict[str, List[str]] = {}
    for rec in stream_fastx(cfg.target):
        reg = regions.get(rec.name)
        if reg is None:
            continue
        info, ordered = region_minimizers(
            rec.seq, reg, cfg.small_k, cfg.small_w
        )
        mx_info[rec.name] = info
        mx_lists[rec.name] = ordered

    # verbose minimizer-graph dump (reference -v; one appended DOT block
    # per overlapping pair). Truncate up front so reruns stay deterministic.
    mx_dot = None
    if cfg.v:
        mx_dot = f"{prefix}.mx.dot"
        if os.path.exists(mx_dot):
            os.unlink(mx_dot)

    outgap = cfg.merge_gap + 1  # abyss-scaffold +1 path-file convention

    paths: Dict[str, List[str]] = {}
    path_entries: List[Tuple[str, List[str]]] = []
    for path_id, tokens in read_path_file(stitch_path_file):
        tokens = normalize_path_tokens(tokens)
        new_path: List[str] = []
        for source, gap, target in zip(tokens, tokens[1:], tokens[2:]):
            m = GAP_RE.match(gap)
            if not m:
                continue
            if int(m.group(1)) <= cfg.g + 1 and graph.has_edge(source, target) \
                    and graph.edge(source, target).d < 0:
                cuts_found = find_overlap_cuts(
                    mx_lists, mx_info, source, target, trims, lengths,
                    graph.edge(source, target).d, cfg.small_k,
                    mx_dot=mx_dot,
                )
                if cuts_found:
                    gap = f"{outgap}N"
            if not new_path:
                new_path.append(source)
            new_path.append(gap)
            new_path.append(target)
        new_path = repair_invalid_trims(new_path, trims, cfg.g, cfg.small_k)
        path_entries.append((path_id, new_path))
        paths[path_id] = new_path

    with open(f"{prefix}.trimmed_scafs.path", "w") as fh:
        for path_id, tokens in path_entries:
            fh.write(f"{path_id}\t{' '.join(tokens)}\n")

    _write_trim_tsv(f"{prefix}.trimmed_scafs.tsv", trims, cfg.small_k)
    _write_trim_agp(f"{prefix}.trimmed_scafs.agp", paths, trims, cfg.small_k)

    trimmed_fa = f"{prefix}.trimmed_scafs.fa"
    with open(trimmed_fa, "w") as fh:
        for rec in stream_fastx(cfg.target):
            name, seq = rec.name, rec.seq
            state = trims[name]
            if state.omitted:
                continue
            if state.ori == "+":
                out_seq = seq[state.target_cut : state.source_cut]
            elif state.ori == "-":
                out_seq = seq[
                    state.adj_source_cut(cfg.small_k) : state.adj_target_cut(cfg.small_k)
                ]
            else:
                out_seq = seq
            if not out_seq:
                out_seq = "N"
            fh.write(f">{name} {state.source_cut}-{state.target_cut}\n{out_seq}\n")
    log("Wrote trimmed scaffolds", trimmed_fa)
    return trimmed_fa


def _write_trim_tsv(path: str, trims: Dict[str, TrimState], k: int) -> None:
    with open(path, "w") as fh:
        for name, state in trims.items():
            if state.omitted:
                continue
            start, end = state.trim_coordinates(k)
            fh.write(f"{name}\t{start}\t{end}\n")


def _write_trim_agp(
    path: str, paths: Dict[str, List[str]], trims: Dict[str, TrimState], k: int
) -> None:
    """AGP of the trimmed layout (reference print_agp_file:514-548)."""
    printed = set()
    with open(path, "w") as fh:
        for path_id, tokens in paths.items():
            start = 1
            component = 1
            for tok in tokens:
                if is_gap(tok):
                    gap = int(GAP_RE.match(tok).group(1)) - 1
                    if gap == 0:
                        continue
                    fh.write(
                        f"{path_id}\t{start}\t{start + gap - 1}\t{component}\t"
                        f"N\t{gap}\tscaffold\tyes\tpaired-ends\n"
                    )
                    start += gap
                else:
                    name, ori = tok[:-1], tok[-1]
                    c_start, c_end = trims[name].trim_coordinates(k)
                    fh.write(
                        f"{path_id}\t{start}\t{start + (c_end - c_start) - 1}\t"
                        f"{component}\tW\t{name}\t{c_start + 1}\t{c_end}\t{ori}\n"
                    )
                    start += c_end - c_start
                    printed.add(name)
                component += 1
        for name, state in trims.items():
            if name in printed or state.omitted:
                continue
            c_start, c_end = state.trim_coordinates(k)
            fh.write(
                f"{name}\t1\t{c_end - c_start}\t1\tW\t{name}\t{c_start + 1}\t"
                f"{c_end}\t+\n"
            )
