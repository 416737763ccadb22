"""Ground-truth oracle for the layout ambiguity heuristics of the PyTorch
port (`ntlink_tpu_torch.layout`), the counterpart of
``scripts/layout_oracle.py`` over the port's own `graphio` and `layout`.

The reference delegates branchy-graph resolution to external C++
(`abyss-scaffold`, ntLink:228-231) whose behavior the committed goldens
never stress; `layout.resolve_ambiguities` replicates its
tip/repeat/weak-edge sequence with two deliberate divergences. This oracle
scores those divergences against synthetic scaffold graphs with KNOWN
truth, built directly at the graph level:

- true chromosome layouts: chains of oriented contigs; every true
  adjacency gets a high-support edge (Poisson around `true_n`), doubled
  with its reverse-complement twin exactly as pairs.build_scaffold_graph
  does,
- transitive evidence: like the real pair tally (ntlink_pair.py:416-435),
  skip-one edges u->w alongside u->v->w at reduced support,
- collapsed repeats: one oriented vertex spliced into multiple chains
  (>= 2 in / >= 2 out),
- chimeric joins: spurious low-support edges between random unrelated
  contigs,
- spur tips: fake short dead-end contigs hanging off real chain vertices
  with low support.

Scoring on layout.layout() output paths vs truth:
- misjoins: output adjacencies not present in the truth adjacency set
  (orientation-normalized),
- recovered: fraction of true adjacencies reproduced,
- N50 over scaffold lengths (gaps excluded, abyss-fac metric).

Variants compared, each over many seeds x noise grids:
  A. tips=support-weighted, reduce-then-resolve   (shipped default)
  B. tips=topological,       reduce-then-resolve
  C. tips=support-weighted,  resolve-then-reduce
  D. tips=topological,       resolve-then-reduce

The graphs come from the same seeds and the same generator as
``scripts/layout_oracle.py``, so the two scripts print the same table
(``tests/torch_port/test_torch_layout_oracle.py`` holds their scores
equal). Host code only: it needs no card.

Usage: python scripts/layout_oracle_torch.py [--seeds N]  (writes a
markdown table to stdout)
"""
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from ntlink_tpu_torch.graphio import EdgeAttr, ScaffoldGraph
from ntlink_tpu_torch.layout import (
    LayoutResult,
    assemble_paths,
    flip_node,
    remove_transitive_edges,
    resolve_ambiguities,
)

CONTIG_LEN = 50_000
GAP = 200


def _flip(n):
    return flip_node(n)


def add_edge_rc(g, u, v, d, n):
    g.add_edge(u, v, EdgeAttr(d, n))
    fu, fv = _flip(u), _flip(v)
    if (fv, fu) != (u, v):
        g.add_edge(fv, fu, EdgeAttr(d, n))


def build_truth_graph(rng, n_chroms=6, chrom_len=12, true_n=12,
                      p_transitive=0.6, n_repeats=2, n_chimeric=6,
                      n_tips=6, noise_n=2, n_tandem=0, chimera_ratio=None,
                      n_neartie=0):
    """Returns (graph, truth_adjacencies, contig_lengths).

    Round-5 adversarial families (VERDICT r4 #7):
    - `n_tandem`: collapsed TANDEM repeats — a repeat vertex spliced into
      one chain with a self-edge (rep->rep), the collapsed signature of
      `...u rep rep v...`,
    - `chimera_ratio`: chimeric joins drawn at this fraction of the TRUE
      edge support (None keeps the old independent Poisson noise) — 0.85
      makes chimeras nearly indistinguishable from real joins by weight,
    - `n_neartie`: near-tie branches — a competing edge out of a real
      chain vertex into another chain at (true support - 1).
    """
    g = ScaffoldGraph()
    lengths = {}
    chroms = []
    cid = 0
    for c in range(n_chroms):
        chain = []
        for i in range(chrom_len):
            name = f"c{cid}"
            cid += 1
            ori = "+" if rng.random() < 0.5 else "-"
            chain.append(name + ori)
            lengths[name] = CONTIG_LEN
        chroms.append(chain)
    for name in lengths:
        g.add_node(name + "+", lengths[name])
        g.add_node(name + "-", lengths[name])

    truth = set()
    for chain in chroms:
        for u, v in zip(chain, chain[1:]):
            truth.add((u, v))
            truth.add((_flip(v), _flip(u)))
            n = max(2, int(rng.poisson(true_n)))
            add_edge_rc(g, u, v, GAP, n)
        # transitive evidence (the pair tally adds skip edges by design)
        for u, m, v in zip(chain, chain[1:], chain[2:]):
            if rng.random() < p_transitive:
                n = max(1, int(rng.poisson(true_n * 0.6)))
                add_edge_rc(g, u, v, 2 * GAP + CONTIG_LEN, n)

    # collapsed repeats: splice one oriented vertex into 2 chains
    repeat_names = []
    for r in range(n_repeats):
        name = f"rep{r}"
        lengths[name] = CONTIG_LEN
        g.add_node(name + "+", CONTIG_LEN)
        g.add_node(name + "-", CONTIG_LEN)
        repeat_names.append(name)
        for _ in range(2):
            chain = chroms[int(rng.integers(0, len(chroms)))]
            i = int(rng.integers(0, len(chain) - 1))
            u, v = chain[i], chain[i + 1]
            n = max(2, int(rng.poisson(true_n)))
            add_edge_rc(g, u, name + "+", GAP, n)
            add_edge_rc(g, name + "+", v, GAP, n)

    # collapsed tandem repeats: one vertex spliced into a single chain
    # position WITH a self-edge — the collapsed form of `u rep rep v`
    for r in range(n_tandem):
        name = f"tnd{r}"
        lengths[name] = CONTIG_LEN
        g.add_node(name + "+", CONTIG_LEN)
        g.add_node(name + "-", CONTIG_LEN)
        chain = chroms[int(rng.integers(0, len(chroms)))]
        i = int(rng.integers(0, len(chain) - 1))
        u, v = chain[i], chain[i + 1]
        n = max(2, int(rng.poisson(true_n)))
        add_edge_rc(g, u, name + "+", GAP, n)
        add_edge_rc(g, name + "+", v, GAP, n)
        add_edge_rc(g, name + "+", name + "+", GAP,
                    max(2, int(rng.poisson(true_n * 0.5))))

    # chimeric joins: spurious edges between unrelated contigs, either at
    # independent low support (noise_n) or scaled to the true support
    names = [c for chain in chroms for c in chain]
    for _ in range(n_chimeric):
        u = names[int(rng.integers(0, len(names)))]
        v = names[int(rng.integers(0, len(names)))]
        if u[:-1] == v[:-1] or (u, v) in truth:
            continue
        if chimera_ratio is not None:
            n = max(1, int(round(chimera_ratio * true_n)))
        else:
            n = max(1, int(rng.poisson(noise_n)))
        add_edge_rc(g, u, v, GAP, n)

    # near-tie branches: a competing out-edge from a real chain vertex
    # into a DIFFERENT chain at (true support - 1) — the weight signal
    # that separates right from wrong is one read pair
    for _ in range(n_neartie):
        a = chroms[int(rng.integers(0, len(chroms)))]
        b = chroms[int(rng.integers(0, len(chroms)))]
        if a is b:
            continue
        i = int(rng.integers(0, len(a) - 1))
        u, v = a[i], a[i + 1]
        true_edge = g.edge(u, v)
        w = b[int(rng.integers(0, len(b)))]
        if (u, w) in truth or w[:-1] == u[:-1]:
            continue
        add_edge_rc(g, u, w, GAP, max(1, true_edge.n - 1))

    # spur tips: fake dead-end contigs off real vertices
    for t in range(n_tips):
        name = f"tip{t}"
        lengths[name] = CONTIG_LEN
        g.add_node(name + "+", CONTIG_LEN)
        g.add_node(name + "-", CONTIG_LEN)
        u = names[int(rng.integers(0, len(names)))]
        add_edge_rc(g, u, name + "+", GAP, max(1, int(rng.poisson(noise_n))))

    return g, truth, lengths


def run_variant(graph, lengths, support_tips, reduce_first, min_weight=2):
    g = graph.filtered_by_weight(min_weight)
    if reduce_first:
        g = remove_transitive_edges(g)
        resolve_ambiguities(g, support_weighted_tips=support_tips)
    else:
        resolve_ambiguities(g, support_weighted_tips=support_tips)
        g = remove_transitive_edges(g)
    paths = assemble_paths(g, 20)
    placed = {n[:-1] for p in paths for n in p.nodes}
    return LayoutResult(paths, placed)


def score(result, truth, lengths):
    out_adj = set()
    for p in result.paths:
        for u, v in zip(p.nodes, p.nodes[1:]):
            out_adj.add((u, v))
    # orientation-normalized truth membership (a path may come out as the
    # RC of the true chain)
    mis = sum(
        1 for (u, v) in out_adj
        if (u, v) not in truth and (_flip(v), _flip(u)) not in truth
    )
    recovered = sum(
        1 for (u, v) in truth if (u, v) in out_adj
        or (_flip(v), _flip(u)) in out_adj
    ) / 2  # truth holds both rc twins
    slens = sorted(result.scaffold_lengths(lengths), reverse=True)
    total = sum(slens)
    acc, n50 = 0, 0
    for L in slens:
        acc += L
        if acc >= total / 2:
            n50 = L
            break
    return mis, recovered, n50


def main():
    seeds = 40
    if "--seeds" in sys.argv:
        seeds = int(sys.argv[sys.argv.index("--seeds") + 1])
    variants = [
        ("A support-tips, reduce-first (shipped)", True, True),
        ("B topo-tips,    reduce-first", False, True),
        ("C support-tips, resolve-first", True, False),
        ("D topo-tips,    resolve-first", False, False),
    ]
    grids = [
        dict(n_chimeric=4, n_tips=4, noise_n=2, label="mild noise"),
        dict(n_chimeric=12, n_tips=12, noise_n=3, label="heavy noise"),
        dict(n_chimeric=8, n_tips=8, noise_n=5, label="strong spurious"),
        # round-5 adversarial families (VERDICT r4 #7)
        dict(n_chimeric=6, n_tips=4, noise_n=2, n_tandem=3,
             label="tandem repeats"),
        dict(n_chimeric=10, n_tips=4, chimera_ratio=0.5,
             label="chimera 0.5x support"),
        dict(n_chimeric=10, n_tips=4, chimera_ratio=0.85,
             label="chimera 0.85x support"),
        dict(n_chimeric=0, n_tips=0, n_neartie=10,
             label="near-tie branches"),
        dict(n_chroms=20, chrom_len=40, n_chimeric=40, n_tips=40,
             n_repeats=6, noise_n=3, label="large graph (800 contigs)"),
    ]
    print("| noise | variant | misjoins/run | recovered % | N50 (kb) |")
    print("|---|---|---|---|---|")
    for grid in grids:
        label = grid.pop("label")
        agg = defaultdict(lambda: [0.0, 0.0, 0.0])
        for s in range(seeds):
            rng = np.random.default_rng(1000 + s)
            g, truth, lengths = build_truth_graph(rng, **grid)
            n_truth = len(truth) / 2
            for name, st, rf in variants:
                mis, rec, n50 = score(
                    run_variant(g, lengths, st, rf), truth, lengths
                )
                a = agg[name]
                a[0] += mis
                a[1] += 100.0 * rec / n_truth
                a[2] += n50
        for name, _, _ in variants:
            a = agg[name]
            print(
                f"| {label} | {name} | {a[0]/seeds:.2f} | "
                f"{a[1]/seeds:.1f} | {a[2]/seeds/1000:.0f} |"
            )


if __name__ == "__main__":
    main()
