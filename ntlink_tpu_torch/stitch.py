"""Path selection and stitching over the layout n-sweep.

Behavioral contract: reference ntlink_stitch_paths.py. The sweep's N50
tables pick the optimal weight threshold; the winning path file becomes a
path graph whose linear components are re-emitted as normalized, sorted,
``ntLink_<id>`` paths. Non-conservative mode merges end-to-end connections
from the alternate path files (with linearization and optional transitive
support filtering) before extracting paths.
"""
from __future__ import annotations

import os
import re

from typing import Dict, List, Optional, Tuple

import numpy as np

from .graphio import ScaffoldGraph, EdgeAttr
from .pathio import (
    GAP_RE,
    flip_oriented,
    is_gap,
    normalize_path_tokens,
    read_path_file,
)

_N_RE = re.compile(r"n=(\d+)\s+s=")


def find_optimal_n(path_files: List[str]) -> Optional[str]:
    """Pick the sweep file with the best N50 (first wins ties)."""
    best_n50, best_file = 0.0, None
    for path_file in path_files:
        sterr = f"{path_file}.sterr"
        if not os.path.exists(sterr):
            continue
        with open(sterr) as fh:
            for line in fh:
                fields = line.strip().split("\t")
                if len(fields) != 11 or fields[5] == "N50":
                    continue
                n50 = float(fields[5])
                if n50 > best_n50:
                    m = _N_RE.search(fields[10])
                    if m:
                        best_n50 = n50
                        best_file = path_file
    return best_file


class PathGraph:
    """Digraph over oriented contigs built from a path file, with RC closure."""

    def __init__(self):
        self.adj: Dict[str, Dict[str, dict]] = {}
        self.radj: Dict[str, Dict[str, dict]] = {}

    def add_node(self, name: str) -> None:
        if name not in self.adj:
            self.adj[name] = {}
            self.radj[name] = {}

    def has_node(self, name: str) -> bool:
        return name in self.adj

    def add_edge(self, s: str, t: str, **attrs) -> None:
        self.add_node(s)
        self.add_node(t)
        self.adj[s][t] = attrs
        self.radj[t][s] = attrs

    def remove_edge(self, s: str, t: str) -> None:
        self.adj[s].pop(t, None)
        self.radj[t].pop(s, None)

    def has_edge(self, s: str, t: str) -> bool:
        return s in self.adj and t in self.adj[s]

    def out_degree(self, n: str) -> int:
        return len(self.adj[n])

    def in_degree(self, n: str) -> int:
        return len(self.radj[n])

    def edges(self):
        for s, targets in self.adj.items():
            for t, attrs in targets.items():
                yield s, t, attrs

    def weak_components(self) -> List[List[str]]:
        seen, comps = set(), []
        for start in self.adj:
            if start in seen:
                continue
            comp, stack = [], [start]
            seen.add(start)
            while stack:
                u = stack.pop()
                comp.append(u)
                for v in list(self.adj[u]) + list(self.radj[u]):
                    if v not in seen:
                        seen.add(v)
                        stack.append(v)
            comps.append(comp)
        return comps


def read_path_graph(path_file: str) -> PathGraph:
    """Load a layout path file into a doubled path graph
    (reference ntlink_stitch_paths.py:21-66)."""
    g = PathGraph()
    for path_id, tokens in read_path_file(path_file):
        for i, j, k in zip(tokens, tokens[1:], tokens[2:]):
            if not is_gap(j):
                continue
            gap = GAP_RE.match(j).group(1)
            for name in (i, k, flip_oriented(i), flip_oriented(k)):
                g.add_node(name)
            assert not g.has_edge(i, k)
            g.add_edge(i, k, d=gap, path_id=path_id)
            g.add_edge(
                flip_oriented(k), flip_oriented(i), d=gap, path_id=path_id
            )
    return g


def _component_simple_path(g: PathGraph, component: List[str]) -> Optional[List[str]]:
    """The unique source->sink simple path covering the whole component."""
    sources = [n for n in component if g.in_degree(n) == 0]
    if len(sources) != 1:
        return None
    sinks = [n for n in component if g.out_degree(n) == 0]
    assert len(sinks) == 1
    comp_set = set(component)
    n_edges = sum(
        1 for s in component for t in g.adj[s] if t in comp_set
    )
    # walk the chain; bail on any branching
    path = [sources[0]]
    visited = {sources[0]}
    node = sources[0]
    while node != sinks[0]:
        succs = [t for t in g.adj[node] if t in comp_set]
        if len(succs) != 1 or succs[0] in visited:
            return None
        node = succs[0]
        path.append(node)
        visited.add(node)
    if len(path) == len(component) and len(path) - 1 == n_edges:
        return path
    return None


def extract_paths(g: PathGraph) -> List[List[Tuple[str, Optional[int]]]]:
    """Linear component paths as [(oriented_contig, gap_to_next|None)]."""
    results = []
    for component in g.weak_components():
        path = _component_simple_path(g, component)
        if path is None:
            continue
        nodes = []
        for a, b in zip(path, path[1:]):
            nodes.append((a, int(g.adj[a][b]["d"])))
        nodes.append((path[-1], None))
        results.append(nodes)
    # drop reverse-complement / duplicate-contig twins, first seen wins
    visited, unique = set(), []
    for path in results:
        if not any(name[:-1] in visited for name, _ in path):
            unique.append(path)
        for name, _ in path:
            visited.add(name[:-1])
    return unique


def render_paths(
    paths: List[List[Tuple[str, Optional[int]]]],
    scaf_num: Optional[int],
    max_gap: int,
) -> List[Tuple[str, List[str]]]:
    """Normalize, sort, and number paths (ntlink_stitch_paths.py:396-420)."""
    token_lists = []
    for path in paths:
        tokens: List[str] = []
        for name, gap in path:
            tokens.append(name)
            if gap is not None:
                if max_gap != -1 and gap > max_gap + 1:
                    gap = max_gap + 1  # +1: abyss-scaffold path convention
                tokens.append(f"{gap}N")
        if len(tokens) < 2:
            continue
        token_lists.append(normalize_path_tokens(tokens))
    token_lists.sort(key=lambda toks: (len(toks), toks[0]), reverse=True)
    next_id = 0 if scaf_num is None else scaf_num + 1
    return [
        (f"ntLink_{next_id + i}", toks) for i, toks in enumerate(token_lists)
    ]


def _add_terminal_edges(
    g: PathGraph,
    alt_file: str,
    new_edges: Dict[str, Dict[str, List[int]]],
    new_vertices: set,
    scaffold_graph: ScaffoldGraph,
    trans_edges: set,
) -> None:
    """Collect end-to-end candidate edges from one alternate path file
    (reference ntlink_stitch_paths.py:120-170)."""
    if not os.path.exists(alt_file):
        return

    def record(gap: int, s: str, t: str) -> None:
        for src, tgt in ((s, t), (flip_oriented(t), flip_oriented(s))):
            new_edges.setdefault(src, {})
            if tgt in new_edges[src]:
                new_edges[src][tgt].append(gap)
            else:
                new_edges[src][tgt] = [gap]

    for _, tokens in read_path_file(alt_file):
        contigs = [tok for tok in tokens if not is_gap(tok)]
        for idx, (s, t) in enumerate(zip(contigs, contigs[1:])):
            if not (g.has_node(s) and g.has_node(t) and g.has_edge(s, t)):
                start, end = max(0, idx - 4), min(len(contigs), idx + 6)
                hood = contigs[start:end]
                cut = hood.index(s) + 1
                for src in hood[:cut]:
                    for tgt in hood[cut:]:
                        if src == s and tgt == t:
                            continue
                        if scaffold_graph.has_edge(src, tgt):
                            continue
                        trans_edges.add((src, tgt))
                        trans_edges.add((flip_oriented(tgt), flip_oriented(src)))
        for i, j, k in zip(tokens, tokens[1:], tokens[2:]):
            if not is_gap(j):
                continue
            gap = int(GAP_RE.match(j).group(1))
            s_in, t_in = g.has_node(i), g.has_node(k)
            if s_in and t_in:
                if g.has_edge(i, k):
                    continue
                if g.out_degree(i) == 0 and g.in_degree(k) == 0:
                    record(gap, i, k)
            elif s_in and not t_in:
                if g.out_degree(i) == 0:
                    new_vertices.update((k, flip_oriented(k)))
                    record(gap, i, k)
            elif t_in and not s_in:
                if g.in_degree(k) == 0:
                    new_vertices.update((i, flip_oriented(i)))
                    record(gap, i, k)
            else:
                new_vertices.update((i, flip_oriented(i), k, flip_oriented(k)))
                record(gap, i, k)


def merge_alternate_paths(
    g: PathGraph,
    path_files: List[str],
    best_file: str,
    scaffold_graph: ScaffoldGraph,
) -> None:
    """Non-conservative stitching: graft end-to-end edges from alternate
    sweep outputs into the path graph (ntlink_stitch_paths.py:188-219)."""
    new_edges: Dict[str, Dict[str, List[int]]] = {}
    new_vertices: set = set()
    trans_edges: set = set()
    for path_file in path_files:
        if path_file == best_file:
            continue
        _add_terminal_edges(
            g, path_file, new_edges, new_vertices, scaffold_graph, trans_edges
        )
    for v in new_vertices:
        g.add_node(v)
    for s, targets in new_edges.items():
        for t, gaps in targets.items():
            g.add_edge(
                s, t, d=int(np.median(gaps)), n=len(gaps), path_id="new"
            )
    for s, t in trans_edges:
        scaffold_graph.add_edge(s, t, EdgeAttr(d=0, n=0))


def linearize(g: PathGraph) -> None:
    """Drop weaker 'new' edges at branch points (ntlink_stitch_paths.py:221-254)."""
    to_remove = set()
    for mode in ("in", "out"):
        adj = g.radj if mode == "in" else g.adj
        for node in list(g.adj):
            incident = [
                ((s, node) if mode == "in" else (node, s)) for s in adj[node]
            ]
            if len(incident) <= 1:
                continue
            attrs = [g.adj[s][t] for s, t in incident]
            keeper = None
            if all(a.get("path_id") == "new" for a in attrs):
                max_n = max(a.get("n", 0) for a in attrs)
                best = [e for e, a in zip(incident, attrs) if a.get("n", 0) == max_n]
                if len(best) == 1:
                    keeper = best[0]
            for edge, a in zip(incident, attrs):
                if edge != keeper and a.get("path_id") == "new":
                    to_remove.add(edge)
    for s, t in to_remove:
        g.remove_edge(s, t)


def transitive_filter(g: PathGraph, scaffold_graph: ScaffoldGraph) -> None:
    """Remove 'new' edges with no transitive support in the scaffold graph
    (ntlink_stitch_paths.py:327-365)."""

    def closure(node: str, forward: bool) -> List[str]:
        adj = g.adj if forward else g.radj
        out, stack, seen = [node], [node], {node}
        while stack:
            u = stack.pop()
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    out.append(v)
                    stack.append(v)
        return out

    def supported(s: str, t: str) -> bool:
        s_pass = t_pass = False
        for ts in closure(s, forward=False):
            for tt in closure(t, forward=True):
                if ts == s and tt == t:
                    continue
                if scaffold_graph.has_edge(ts, tt):
                    if ts == s or tt == t:
                        s_pass = s_pass or ts == s
                        t_pass = t_pass or tt == t
                        if s_pass and t_pass:
                            return True
                    else:
                        return True
        return False

    doomed = [
        (s, t)
        for s, t, attrs in g.edges()
        if attrs.get("path_id") == "new" and not supported(s, t)
    ]
    for s, t in doomed:
        g.remove_edge(s, t)


def stitch(
    path_files: List[str],
    scaffold_graph: ScaffoldGraph,
    out_path: str,
    max_gap: int,
    conservative: bool = True,
    use_transitive: bool = False,
) -> None:
    """Full stitch stage: optimal-n selection then path extraction."""
    best = find_optimal_n(path_files)
    if best is None:
        with open(out_path, "w") as fh:
            pass
        return
    g = read_path_graph(best)
    if not conservative:
        merge_alternate_paths(g, path_files, best, scaffold_graph)
        linearize(g)
        if use_transitive:
            transitive_filter(g, scaffold_graph)
    paths = extract_paths(g)
    entries = render_paths(paths, scaffold_graph.scaf_num, max_gap)
    with open(out_path, "w") as fh:
        for path_id, tokens in entries:
            fh.write(f"{path_id}\t{' '.join(tokens)}\n")
