"""Scaffold layout engine — replaces external ABySS `abyss-scaffold`.

Given the scaffold graph (doubled reverse-complement-closed digraph with gap
estimates `d` and support `n`), lay out linear scaffold paths:

1. drop edges with support below the weight threshold,
2. remove transitive edges (an edge u->w bypassed by a longer u..w path):
   these arise from the pair tally's full transitive edge addition
   (reference ntlink_pair.py:416-435) and must not break unambiguous chains,
3. resolve ambiguous subgraphs the way ABySS Scaffold does — prune tips,
   clear repeat vertices, drop doubly-dominated weak edges, prune tips
   again (see the function docstrings; DESIGN.md documents each heuristic
   and where it intentionally diverges),
4. assemble maximal unambiguous chains (every link u->v with out_degree(u)==1
   and in_degree(v)==1),
5. deduplicate reverse-complement twins,
6. render the path file with the abyss-scaffold gap convention:
   gap = max(d, min_gap) + 1,
7. emit an n-sweep N50 table (abyss-fac format) used for optimal-n selection.

The contract (path-file grammar, +1 gap bias, stderr table consumed by the
stitch stage) is reverse-engineered from the reference pipeline's goldens;
see DESIGN.md and PARITY.md. On fully unambiguous graphs (all the golden
datasets) the ambiguity passes are structural no-ops, preserving byte parity.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

from .graphio import ScaffoldGraph
from .stats import FAC_HEADER, fac_row

MAX_TRANSITIVE_HOPS = 16


def flip_node(name: str) -> str:
    return name[:-1] + ("-" if name.endswith("+") else "+")


def _has_alternate_path(
    g: ScaffoldGraph, source: str, target: str, max_hops: int = MAX_TRANSITIVE_HOPS
) -> bool:
    """True if target is reachable from source without the direct edge."""
    frontier = [
        (v, 1) for v in g.successors(source) if v != target
    ]
    seen = {source}
    while frontier:
        node, depth = frontier.pop()
        if node == target:
            return True
        if depth >= max_hops or node in seen:
            continue
        seen.add(node)
        for nxt in g.successors(node):
            if nxt == target:
                return True
            frontier.append((nxt, depth + 1))
    return False


def remove_transitive_edges(g: ScaffoldGraph) -> ScaffoldGraph:
    """Remove every edge bypassed by an alternative directed path
    (<= MAX_TRANSITIVE_HOPS hops; sequential per-edge semantics, so an
    edge removed earlier is no longer available as a first hop).

    The native C kernel (native/graph.c) replicates the walk exactly —
    including the traversal-order-sensitive seen-marking — and runs the
    whole reduction in one GIL-released call; the Python early-exit DFS
    is the fallback (it beat a grouped origin-tracking BFS by 3-6x in
    Python constants; see tests/test_layout_ambiguous.py perf case).
    Wall-clock scaling for big noisy graphs additionally comes from
    running the n-sweep's ten thresholds in parallel worker processes
    (run_n_sweep threads=).
    """
    out = g.copy()
    edges = list(g.edges())
    if not edges:
        return out

    from .native import graph_module

    mod = graph_module()
    if mod is not None:
        import numpy as np

        node_id = {name: i for i, name in enumerate(out.nodes())}
        src = np.fromiter(
            (node_id[s] for s, _, _ in edges), np.int32, len(edges)
        )
        dst = np.fromiter(
            (node_id[t] for _, t, _ in edges), np.int32, len(edges)
        )
        keep = mod.transitive_reduce(
            len(node_id), src, dst, MAX_TRANSITIVE_HOPS
        )
        for (s, t, _), kept in zip(edges, keep):
            if not kept:
                out.remove_edge(s, t)
        return out

    for s, t, _ in edges:
        if _has_alternate_path(out, s, t):
            out.remove_edge(s, t)
    return out


# -- ambiguous-graph resolution (ABySS Scaffold heuristics) -----------------
#
# Real long-read data produces branchy scaffold graphs (repeats, chimeric
# joins, spurious low-support links). The reference resolves them inside
# `abyss-scaffold` (invoked ntLink:228-231); these passes replicate its
# tip / repeat / weak-edge handling on our doubled RC-closed graph. Every
# mutation is mirrored onto the reverse-complement twin edge so the graph
# stays RC-closed (assemble_paths relies on that for twin dedup).


def remove_edge_rc(g: ScaffoldGraph, u: str, v: str) -> None:
    """Remove edge (u, v) and its reverse-complement twin."""
    g.remove_edge(u, v)
    fu, fv = flip_node(u), flip_node(v)
    if (fv, fu) != (u, v):
        g.remove_edge(fv, fu)


def prune_tips(g: ScaffoldGraph, support_weighted: bool = True) -> int:
    """Drop links into dead-end branches, iterating to a fixpoint.

    A tip is a vertex t with in_degree==1 and out_degree==0 whose sole
    predecessor u branches (out_degree(u) > 1). With
    `support_weighted=True` (the default, measured better on the synthetic
    truth oracle — scripts/layout_oracle.py, table in DESIGN.md) a tip
    link is cut only when it is strictly weaker than u's best-supported
    out-edge: a dead-end that carries the strongest evidence is kept (it
    may be the genuine chromosome end) and the ambiguity stands.
    `support_weighted=False` is the purely topological ABySS-style variant
    (every tip off a branching predecessor is cut), kept for the oracle
    comparison. Returns the number of removed links.
    """
    removed = 0
    changed = True
    while changed:
        changed = False
        for u in list(g.nodes()):
            if g.out_degree(u) < 2:
                continue
            succs = list(g.successors(u))
            best_n = max(g.edge(u, t).n for t in succs)
            doomed = [
                t for t in succs
                if g.out_degree(t) == 0
                and g.in_degree(t) == 1
                and (not support_weighted or g.edge(u, t).n < best_n)
                and g.out_degree(u) > 1
            ]
            if not support_weighted and len(doomed) == len(succs):
                # topological mode: never strand the predecessor entirely —
                # keep its best-supported continuation
                best_t = max(doomed, key=lambda t: g.edge(u, t).n)
                doomed = [t for t in doomed if t != best_t]
            for t in doomed:
                remove_edge_rc(g, u, t)
                removed += 1
                changed = True
    return removed


def remove_repeats(g: ScaffoldGraph) -> List[str]:
    """Clear vertices that look like collapsed repeats.

    A repeat vertex has >= 2 predecessors and >= 2 successors: it cannot
    sit inside any unambiguous chain, and its links inflate the degree of
    every neighbour. Clearing it (ABySS Scaffold's removeRepeats) lets the
    flanking contigs link through their remaining evidence; the repeat is
    emitted as a singleton. Returns the cleared (oriented) vertices.
    """
    cleared = []
    for v in list(g.nodes()):
        if v.endswith("-"):
            continue  # handle each contig once; twin mirrored below
        if g.in_degree(v) < 2 or g.out_degree(v) < 2:
            continue
        for t in list(g.successors(v)):
            remove_edge_rc(g, v, t)
        for s in list(g.predecessors(v)):
            remove_edge_rc(g, s, v)
        fv = flip_node(v)
        for t in list(g.successors(fv)):
            remove_edge_rc(g, fv, t)
        for s in list(g.predecessors(fv)):
            remove_edge_rc(g, s, fv)
        cleared.append(v)
    return cleared


def remove_weak_edges(g: ScaffoldGraph) -> int:
    """Drop edges dominated at BOTH endpoints (ABySS Scaffold semantics).

    An edge (u, v) is weak when some other edge out of u has strictly
    greater support AND some other edge into v has strictly greater
    support. One simultaneous pass over a snapshot (removals do not
    cascade within the pass); returns the number of removed edges.
    """
    weak = []
    for u, v, attr in list(g.edges()):
        out_better = any(
            g.edge(u, t).n > attr.n for t in g.successors(u) if t != v
        )
        if not out_better:
            continue
        in_better = any(
            g.edge(s, v).n > attr.n for s in g.predecessors(v) if s != u
        )
        if in_better:
            weak.append((u, v))
    for u, v in weak:
        if g.has_edge(u, v):
            remove_edge_rc(g, u, v)
    return len(weak)


def resolve_ambiguities(g: ScaffoldGraph, support_weighted_tips: bool = True
                        ) -> None:
    """ABySS Scaffold's resolution sequence: tips, repeats, weak edges,
    tips again (in place). No-op on fully unambiguous graphs."""
    prune_tips(g, support_weighted_tips)
    remove_repeats(g)
    remove_weak_edges(g)
    prune_tips(g, support_weighted_tips)


@dataclass
class LayoutPath:
    nodes: List[str]            # oriented contig names
    gaps: List[int]             # len(nodes)-1 path-file gap values (+1 biased)

    def render(self) -> str:
        parts = [self.nodes[0]]
        for gap, node in zip(self.gaps, self.nodes[1:]):
            parts.append(f"{gap}N")
            parts.append(node)
        return " ".join(parts)


def assemble_paths(
    g: ScaffoldGraph, min_gap: int
) -> List[LayoutPath]:
    """Extract maximal unambiguous chains, one per reverse-complement pair."""
    def linked(u: str, v: str) -> bool:
        return g.out_degree(u) == 1 and g.in_degree(v) == 1

    paths = []
    used = set()
    for start in g.nodes():
        if start in used:
            continue
        # chain start: no unambiguous incoming link
        preds = list(g.predecessors(start))
        if len(preds) == 1 and linked(preds[0], start):
            continue
        chain = [start]
        node = start
        while True:
            succs = list(g.successors(node))
            if len(succs) == 1 and linked(node, succs[0]) and succs[0] not in used:
                nxt = succs[0]
                if nxt in chain:  # cycle guard
                    break
                chain.append(nxt)
                node = nxt
            else:
                break
        if len(chain) < 2:
            continue
        for n in chain:
            used.add(n)
            used.add(flip_node(n))
        gaps = [
            max(g.edge(u, v).d, min_gap) + 1 for u, v in zip(chain, chain[1:])
        ]
        paths.append(LayoutPath(chain, gaps))
    return paths


@dataclass
class LayoutResult:
    paths: List[LayoutPath]
    placed: set                   # unoriented contig names inside paths

    def scaffold_lengths(self, contig_lengths: Dict[str, int]) -> List[int]:
        """Layout lengths with the abyss-fac metric (gaps excluded)."""
        lengths = [
            sum(contig_lengths[n[:-1]] for n in p.nodes) for p in self.paths
        ]
        for contig, length in contig_lengths.items():
            if contig not in self.placed:
                lengths.append(length)
        return lengths


def layout(
    graph: ScaffoldGraph,
    contig_lengths: Dict[str, int],
    min_weight: int,
    seed_length: int,
    min_gap: int,
) -> LayoutResult:
    g = graph.filtered_by_weight(min_weight)
    # drop short-seed vertices (abyss-scaffold -s)
    for node in list(g.nodes()):
        if g.node_lengths.get(node, 0) < seed_length:
            for t in list(g.successors(node)):
                g.remove_edge(node, t)
            for s in list(g.predecessors(node)):
                g.remove_edge(s, node)
    g = remove_transitive_edges(g)
    resolve_ambiguities(g)
    paths = assemble_paths(g, min_gap)
    placed = {n[:-1] for p in paths for n in p.nodes}
    return LayoutResult(paths, placed)


def _sweep_one(args) -> Tuple[int, str, str]:
    """One n-threshold layout, rendered (worker-process friendly)."""
    graph, contig_lengths, n, seed_length, min_gap = args
    result = layout(graph, contig_lengths, n, seed_length, min_gap)
    body = "".join(
        f"{i}\t{p.render()}\n" for i, p in enumerate(result.paths)
    )
    sterr = (
        FAC_HEADER + "\n"
        + fac_row(
            result.scaffold_lengths(contig_lengths), f"n={n} s={seed_length}"
        )
        + "\n"
    )
    return n, body, sterr


def run_n_sweep(
    graph: ScaffoldGraph,
    contig_lengths: Dict[str, int],
    n_min: int,
    n_max: int,
    seed_length: int,
    min_gap: int,
    prefix: str,
    threads: int = 1,
) -> List[str]:
    """Write `<prefix>.n{i}.abyss-scaffold.path` (+ `.sterr` N50 table) for
    every weight threshold in [n_min, n_max]; returns the path filenames.

    Mirrors the reference's sweep artifacts (ntLink:156-158, 228-231). The
    sweep is embarrassingly parallel: with `threads` > 1 (the reference's
    `t=` knob) the per-n layouts run in worker processes — worthwhile on
    dense noisy graphs, pure overhead on golden-scale ones.
    """
    jobs = [
        (graph, contig_lengths, n, seed_length, min_gap)
        for n in range(n_min, n_max + 1)
    ]
    rendered = None
    if threads > 1 and len(jobs) > 1 and graph.n_edges() >= 512:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        from concurrent.futures.process import BrokenProcessPool

        # spawn, not fork: the parent process usually has JAX's thread pools
        # live by this stage, and forking a multithreaded process can
        # deadlock the child (os.fork RuntimeWarning under JAX). Spawn
        # re-imports the caller's __main__, so a calling script without an
        # `if __name__ == "__main__"` guard breaks the pool — fall back to
        # the serial sweep rather than failing the pipeline.
        try:
            with ProcessPoolExecutor(
                max_workers=min(threads, len(jobs)),
                mp_context=multiprocessing.get_context("spawn"),
            ) as ex:
                rendered = list(ex.map(_sweep_one, jobs))
        except BrokenProcessPool:
            rendered = None
    if rendered is None:
        rendered = [_sweep_one(job) for job in jobs]

    out_files = []
    for n, body, sterr in rendered:
        path_file = f"{prefix}.n{n}.abyss-scaffold.path"
        with open(path_file, "w") as fh:
            fh.write(body)
        with open(path_file + ".sterr", "w") as fh:
            fh.write(sterr)
        out_files.append(path_file)
    return out_files
