"""Scaffold graph structure + DOT dialect IO.

The graph is a plain insertion-ordered digraph over oriented contig names
("ctg+"/"ctg-") with edge attributes d (gap estimate), e (constant 100) and
n (supporting reads). The DOT dialect matches the reference wire format
(writer ntlink_pair.py:133-155, regex reader ntlink_utils.py:90-144) with one
non-semantic difference: node lines are emitted in sorted order (the
reference's node order comes from a Python set and is not reproducible).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from .pairs import PairTally


@dataclass
class EdgeAttr:
    d: int
    n: int
    e: int = 100


class ScaffoldGraph:
    """Directed graph over oriented contigs, insertion-ordered edges."""

    def __init__(self):
        self.node_lengths: Dict[str, int] = {}
        self.adj: Dict[str, Dict[str, EdgeAttr]] = {}
        self.radj: Dict[str, Dict[str, EdgeAttr]] = {}
        self.scaf_num: Optional[int] = None

    # -- construction ------------------------------------------------------

    def add_node(self, name: str, length: int = 0) -> None:
        if name not in self.node_lengths:
            self.node_lengths[name] = length
            self.adj[name] = {}
            self.radj[name] = {}
        elif length:
            self.node_lengths[name] = length

    def add_edge(self, source: str, target: str, attr: EdgeAttr) -> None:
        self.add_node(source)
        self.add_node(target)
        self.adj[source][target] = attr
        self.radj[target][source] = attr

    def remove_edge(self, source: str, target: str) -> None:
        self.adj[source].pop(target, None)
        self.radj[target].pop(source, None)

    # -- queries -----------------------------------------------------------

    def has_edge(self, source: str, target: str) -> bool:
        return source in self.adj and target in self.adj[source]

    def edge(self, source: str, target: str) -> EdgeAttr:
        return self.adj[source][target]

    def nodes(self) -> Iterable[str]:
        return self.node_lengths.keys()

    def edges(self) -> Iterator[Tuple[str, str, EdgeAttr]]:
        for s, targets in self.adj.items():
            for t, attr in targets.items():
                yield s, t, attr

    def out_degree(self, node: str) -> int:
        return len(self.adj.get(node, ()))

    def in_degree(self, node: str) -> int:
        return len(self.radj.get(node, ()))

    def successors(self, node: str) -> Iterable[str]:
        return self.adj.get(node, {}).keys()

    def predecessors(self, node: str) -> Iterable[str]:
        return self.radj.get(node, {}).keys()

    def n_edges(self) -> int:
        return sum(len(t) for t in self.adj.values())

    def copy(self) -> "ScaffoldGraph":
        g = ScaffoldGraph()
        g.scaf_num = self.scaf_num
        for name, length in self.node_lengths.items():
            g.add_node(name, length)
        for s, t, attr in self.edges():
            g.add_edge(s, t, EdgeAttr(attr.d, attr.n, attr.e))
        return g

    def filtered_by_weight(self, min_weight: int) -> "ScaffoldGraph":
        """Copy with edges of weight < min_weight removed (nodes retained)."""
        g = self.copy()
        for s, t, attr in list(g.edges()):
            if attr.n < min_weight:
                g.remove_edge(s, t)
        return g

    def weak_components(self) -> List[List[str]]:
        """Connected components ignoring direction, in node-insertion order."""
        seen = set()
        comps = []
        for start in self.node_lengths:
            if start in seen:
                continue
            comp, stack = [], [start]
            seen.add(start)
            while stack:
                u = stack.pop()
                comp.append(u)
                for v in list(self.successors(u)) + list(self.predecessors(u)):
                    if v not in seen:
                        seen.add(v)
                        stack.append(v)
            comps.append(comp)
        return comps


_NTLINK_ID_RE = re.compile(r"^ntLink_(\d+)$")


def largest_ntlink_id(scaffold_names: Iterable[str]) -> Optional[int]:
    """Largest N over names matching ntLink_N (ntlink_pair.py:118-131)."""
    best = None
    for name in scaffold_names:
        m = _NTLINK_ID_RE.match(name)
        if m:
            val = int(m.group(1))
            best = val if best is None or val > best else best
    return best


def graph_from_tally(
    tally: PairTally, contig_lengths: Dict[str, int]
) -> ScaffoldGraph:
    """Build the doubled (reverse-complement-closed) scaffold graph."""
    g = ScaffoldGraph()
    for pair, ev in tally.pairs.items():
        rc = pair.reverse_complement()
        attr = EdgeAttr(d=ev.gap_estimate(), n=ev.n_supporting)
        for name in (pair.source_name, pair.target_name, rc.source_name, rc.target_name):
            g.add_node(name, contig_lengths[name[:-1]])
        if g.has_edge(pair.source_name, pair.target_name) or g.has_edge(
            rc.source_name, rc.target_name
        ):
            raise AssertionError(f"duplicate edge for pair {pair}")
        g.add_edge(pair.source_name, pair.target_name, attr)
        g.add_edge(rc.source_name, rc.target_name, EdgeAttr(attr.d, attr.n, attr.e))
    return g


def write_dot(graph: ScaffoldGraph, path: str, scaf_num: Optional[int]) -> None:
    with open(path, "w") as fh:
        fh.write("digraph G {\n")
        fh.write(f"graph [scaf_num={scaf_num}]\n")
        for name in sorted(graph.nodes()):
            fh.write(f'"{name}" [l={graph.node_lengths[name]}]\n')
        for s, t, attr in graph.edges():
            fh.write(f'"{s}" -> "{t}" [d={attr.d} e={attr.e} n={attr.n}]\n')
        fh.write("}\n")


_SCAF_NUM_RE = re.compile(r"graph \[scaf_num=(\S+)\]")
_NODE_RE = re.compile(r"\"(\S+[+-])\"\s+\[l=(\d+)\]")
_EDGE_RE = re.compile(
    r"\"(\S+[+-])\"\s+->\s+\"(\S+[+-])\"\s+\[d=(-?\d+)\s+e=(\d+)\s+n=(\d+)\]"
)


def read_dot(path: str) -> ScaffoldGraph:
    """Parse the scaffold-graph DOT dialect (either writer's output)."""
    g = ScaffoldGraph()
    with open(path) as fh:
        first = True
        for line in fh:
            line = line.strip()
            if first:
                first = False
                continue
            m = _NODE_RE.search(line)
            if m:
                g.add_node(m.group(1), int(m.group(2)))
                continue
            m = _EDGE_RE.search(line)
            if m:
                g.add_edge(
                    m.group(1),
                    m.group(2),
                    EdgeAttr(d=int(m.group(3)), e=int(m.group(4)), n=int(m.group(5))),
                )
                continue
            m = _SCAF_NUM_RE.search(line)
            if m:
                try:
                    g.scaf_num = int(m.group(1))
                except ValueError:
                    g.scaf_num = None
    return g


def graphs_equal(a: ScaffoldGraph, b: ScaffoldGraph) -> bool:
    """Semantic equality (node set + lengths, edge set + attrs)."""
    if a.node_lengths != b.node_lengths:
        return False
    ea = {(s, t): (attr.d, attr.e, attr.n) for s, t, attr in a.edges()}
    eb = {(s, t): (attr.d, attr.e, attr.n) for s, t, attr in b.edges()}
    return ea == eb
