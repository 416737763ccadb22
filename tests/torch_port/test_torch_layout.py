"""The port's layout engine and stitch stage (`layout.py`, `stitch.py`,
`graphio.py`, the native `graph.c`), after ``tests/test_layout_ambiguous.py``
and ``tests/test_layout_stitch.py``: the ABySS-scaffold heuristics on
ambiguous graphs (tips pruned by support, ties kept conservative, weak
edges dominated at both ends, repeat vertices cleared, reverse-complement
symmetry kept, the noisy backbone recovered), transitive reduction (the
dense graph within its time limit, the C kernel equal to the Python walk,
the hop limit), the serial and parallel n-sweeps equal, and layout, the
sweep's choice of n and both stitch modes on small chain graphs. Each test
is the JAX package's, run against the port's modules."""
import filecmp
import time

import numpy as np

from ntlink_tpu_torch.graphio import EdgeAttr, ScaffoldGraph
from ntlink_tpu_torch.layout import (
    MAX_TRANSITIVE_HOPS,
    _has_alternate_path,
    assemble_paths,
    flip_node,
    layout,
    prune_tips,
    remove_repeats,
    remove_transitive_edges,
    remove_weak_edges,
    resolve_ambiguities,
    run_n_sweep,
)
from ntlink_tpu_torch.native import graph_module
from ntlink_tpu_torch.stitch import find_optimal_n, stitch


def add_pair(g, u, v, n=3, d=100):
    """Add an oriented link and its reverse-complement twin."""
    g.add_edge(u, v, EdgeAttr(d=d, n=n))
    g.add_edge(flip_node(v), flip_node(u), EdgeAttr(d=d, n=n))


def build(edges, lengths=None):
    g = ScaffoldGraph()
    for e in edges:
        add_pair(g, *e)
    for name in list(g.nodes()):
        g.node_lengths[name] = (lengths or {}).get(name[:-1], 5000)
    return g


def path_sets(paths):
    return {tuple(p.nodes) for p in paths}


def canonical(paths):
    """One representative per RC twin pair."""
    out = set()
    for p in paths:
        fwd = tuple(p.nodes)
        rev = tuple(flip_node(n) for n in reversed(p.nodes))
        out.add(min(fwd, rev))
    return out


def test_tip_pruned_chain_continues():
    # A -> B -> C with a spurious dead-end branch B -> T
    g = build([("A+", "B+", 5), ("B+", "C+", 5), ("B+", "T+", 1)])
    assert prune_tips(g) == 1
    paths = assemble_paths(g, min_gap=20)
    assert canonical(paths) == {("A+", "B+", "C+")}


def test_all_tip_fork_keeps_best_supported():
    g = build([("A+", "B+", 5), ("B+", "T1+", 5), ("B+", "T2+", 1)])
    prune_tips(g)
    paths = assemble_paths(g, min_gap=20)
    assert canonical(paths) == {("A+", "B+", "T1+")}


def test_all_tip_fork_tie_is_conservative():
    g = build([("A+", "B+", 5), ("B+", "T1+", 2), ("B+", "T2+", 2)])
    assert prune_tips(g) == 0
    paths = assemble_paths(g, min_gap=20)
    # B keeps both tips: only A-B links
    assert canonical(paths) == {("A+", "B+")}


def test_weak_edge_dominated_both_ends_removed():
    # two real chains A->B and C->D plus a weak chimeric link A->D
    g = build([("A+", "B+", 5), ("C+", "D+", 4), ("A+", "D+", 1)])
    assert remove_weak_edges(g) == 2  # the edge and its RC twin snapshot
    paths = assemble_paths(g, min_gap=20)
    assert canonical(paths) == {("A+", "B+"), ("C+", "D+")}


def test_weak_edge_tie_survives():
    g = build([("A+", "B+", 5), ("C+", "D+", 4), ("A+", "D+", 5)])
    assert remove_weak_edges(g) == 0
    # ambiguity remains: no false joins either way
    paths = assemble_paths(g, min_gap=20)
    assert canonical(paths) == {("C+", "D+")} or paths == []


def test_repeat_vertex_cleared_unblocks_neighbor():
    # A links to both a repeat R (in 2 / out 2) and its true successor B;
    # clearing R leaves A -> B unambiguous
    g = build(
        [
            ("A+", "R+", 3),
            ("X+", "R+", 3),
            ("R+", "Y+", 3),
            ("R+", "Z+", 3),
            ("A+", "B+", 3),
        ]
    )
    cleared = remove_repeats(g)
    assert cleared == ["R+"]
    assert g.out_degree("R+") == 0 and g.in_degree("R+") == 0
    assert g.out_degree("R-") == 0 and g.in_degree("R-") == 0
    paths = assemble_paths(g, min_gap=20)
    assert ("A+", "B+") in canonical(paths)


def test_rc_symmetry_preserved():
    g = build(
        [
            ("A+", "B+", 5),
            ("B+", "C+", 5),
            ("B+", "T+", 1),
            ("A+", "D-", 1),
            ("E-", "D-", 4),
            ("Q+", "R+", 3),
            ("X+", "R+", 3),
            ("R+", "Y+", 3),
            ("R+", "Z+", 3),
        ]
    )
    resolve_ambiguities(g)
    for u, v, _ in g.edges():
        assert g.has_edge(flip_node(v), flip_node(u)), (u, v)


def test_layout_end_to_end_with_noise_beats_conservative():
    """Full layout() on a noisy graph: the heuristics recover the 4-contig
    backbone that unambiguous-chains-only layout would shatter."""
    edges = [
        ("A+", "B+", 6),
        ("B+", "C+", 6),
        ("C+", "D+", 6),
        ("B+", "T+", 1),   # tip off the backbone
        ("E+", "C+", 1),   # weak chimeric link into C (dominated both ends)
        ("E+", "F+", 4),
    ]
    g = build(edges)
    lengths = {n[:-1]: 5000 for n in g.nodes()}
    res = layout(g, lengths, min_weight=1, seed_length=100, min_gap=20)
    joined = canonical(res.paths)
    assert ("A+", "B+", "C+", "D+") in joined
    assert ("E+", "F+") in joined
    # N50 with the backbone joined: 4 contigs in one scaffold
    ls = sorted(res.scaffold_lengths(lengths), reverse=True)
    assert ls[0] == 4 * 5000


def test_transitive_reduction_dense_graph_stays_fast():
    """Realistic noisy regimes (local branch noise on a backbone; repeat
    hubs with many long links): one reduction stays around a second, and
    the parallel n-sweep spreads the ten thresholds over workers."""
    rng = np.random.default_rng(3)
    g = ScaffoldGraph()
    n = 1500
    names = [f"v{i}+" for i in range(n)]
    for x in names:
        g.add_node(x, 5000)
    for i in range(n - 1):
        g.add_edge(names[i], names[i + 1], EdgeAttr(d=100, n=5))
    for _ in range(6000):  # local noise
        a = int(rng.integers(0, n))
        b = a + int(rng.integers(-20, 21))
        if 0 <= b < n and a != b:
            g.add_edge(names[a], names[b], EdgeAttr(d=100, n=1))
    for i in range(0, n, 15):  # repeat hubs with long links
        for _ in range(20):
            b = int(rng.integers(0, n))
            if b != i:
                g.add_edge(names[i], names[b], EdgeAttr(d=100, n=1))
    t0 = time.time()
    remove_transitive_edges(g)
    assert time.time() - t0 < 3.0


def test_parallel_n_sweep_matches_serial(tmp_path, monkeypatch):
    """run_n_sweep with worker processes writes byte-identical sweep
    artifacts to the serial path."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(9)
    g = ScaffoldGraph()
    n = 300
    names = [f"v{i}" for i in range(n)]
    lengths = {}
    for x in names:
        ln = int(rng.integers(2000, 9000))
        lengths[x] = ln
        g.add_node(x + "+", ln)
        g.add_node(x + "-", ln)
    for i in range(n - 1):
        w = int(rng.integers(1, 8))
        g.add_edge(names[i] + "+", names[i + 1] + "+", EdgeAttr(d=100, n=w))
        g.add_edge(names[i + 1] + "-", names[i] + "-", EdgeAttr(d=100, n=w))
    for _ in range(400):
        a, b = rng.integers(0, n, 2)
        if a == b or g.has_edge(names[a] + "+", names[b] + "+"):
            continue
        g.add_edge(names[a] + "+", names[b] + "+", EdgeAttr(d=100, n=1))
        g.add_edge(names[b] + "-", names[a] + "-", EdgeAttr(d=100, n=1))

    serial = run_n_sweep(g, lengths, 1, 5, 1000, 20, "ser", threads=1)
    parallel = run_n_sweep(g, lengths, 1, 5, 1000, 20, "par", threads=4)
    assert len(serial) == len(parallel)
    for a, b in zip(serial, parallel):
        assert filecmp.cmp(a, b, shallow=False)
        assert filecmp.cmp(a + ".sterr", b + ".sterr", shallow=False)


def test_native_transitive_reduce_matches_python():
    """The C kernel (native/graph.c) is bit-compatible with the Python
    sequential walk — same removals on random dense digraphs, including
    the traversal-order-sensitive cases near the hop limit."""
    mod = graph_module()
    assert mod is not None, "native graph module failed to build"

    def python_reduce(g):
        out = g.copy()
        for s, t, _ in list(g.edges()):
            if _has_alternate_path(out, s, t):
                out.remove_edge(s, t)
        return out

    rng = np.random.default_rng(11)
    for trial in range(20):
        n = int(rng.integers(4, 60))
        g = ScaffoldGraph()
        names = [f"v{i}+" for i in range(n)]
        for x in names:
            g.add_node(x, 5000)
        n_edges = int(rng.integers(n, 5 * n))
        seen = set()
        for _ in range(n_edges):
            a, b = int(rng.integers(0, n)), int(rng.integers(0, n))
            if a == b or (a, b) in seen:
                continue
            seen.add((a, b))
            g.add_edge(names[a], names[b], EdgeAttr(d=100, n=1))

        expected = python_reduce(g)
        got = remove_transitive_edges(g)  # uses the native kernel
        ge = {(s, t) for s, t, _ in got.edges()}
        ee = {(s, t) for s, t, _ in expected.edges()}
        assert ge == ee, f"trial {trial}: native != python"


def test_native_transitive_reduce_deep_chain_hop_limit():
    """A bypass longer than MAX_TRANSITIVE_HOPS must NOT remove the direct
    edge; exactly at the limit it must (both engines agree)."""
    for extra, expect_removed in ((0, True), (3, False)):
        hops = MAX_TRANSITIVE_HOPS + extra
        g = ScaffoldGraph()
        names = [f"c{i}+" for i in range(hops + 1)]
        for x in names:
            g.add_node(x, 5000)
        for i in range(hops):
            g.add_edge(names[i], names[i + 1], EdgeAttr(d=100, n=5))
        g.add_edge(names[0], names[-1], EdgeAttr(d=100, n=1))  # direct
        out = remove_transitive_edges(g)
        assert out.has_edge(names[0], names[-1]) == (not expect_removed)


# ---- after tests/test_layout_stitch.py ----


def chain_graph(edges, lengths):
    g = ScaffoldGraph()
    for name, l in lengths.items():
        for ori in "+-":
            g.add_node(name + ori, l)
    for s, t, d, n in edges:
        g.add_edge(s, t, EdgeAttr(d=d, n=n))
        flip = lambda x: x[:-1] + ("-" if x[-1] == "+" else "+")
        g.add_edge(flip(t), flip(s), EdgeAttr(d=d, n=n))
    return g


LENGTHS = {"A": 2000, "B": 3000, "C": 4000, "D": 5000}


def test_transitive_reduction_keeps_chain():
    g = chain_graph(
        [
            ("A+", "B+", 100, 10),
            ("B+", "C+", 200, 10),
            ("A+", "C+", 3350, 4),   # transitive over B
        ],
        LENGTHS,
    )
    r = remove_transitive_edges(g)
    assert r.has_edge("A+", "B+") and r.has_edge("B+", "C+")
    assert not r.has_edge("A+", "C+")


def test_layout_chain_with_min_gap_and_bias():
    g = chain_graph([("A+", "B-", -50, 5), ("B-", "C+", 7, 5)], LENGTHS)
    res = layout(g, LENGTHS, min_weight=1, seed_length=1000, min_gap=20)
    assert len(res.paths) == 1
    # clamped to min_gap, +1 path-file bias
    assert res.paths[0].render() in (
        "A+ 21N B- 21N C+",
        "C- 21N B+ 21N A-",
    )


def test_layout_weight_filter_breaks_weak_edge():
    g = chain_graph([("A+", "B+", 100, 5), ("B+", "C+", 100, 1)], LENGTHS)
    res = layout(g, LENGTHS, min_weight=3, seed_length=1000, min_gap=20)
    assert len(res.paths) == 1
    assert set(n[:-1] for n in res.paths[0].nodes) == {"A", "B"}


def test_ambiguous_fork_not_joined():
    g = chain_graph(
        [("A+", "B+", 100, 5), ("A+", "C+", 100, 5)], LENGTHS
    )
    res = layout(g, LENGTHS, min_weight=1, seed_length=1000, min_gap=20)
    assert res.paths == []


def test_n_sweep_and_optimal_selection(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    g = chain_graph([("A+", "B+", 100, 5), ("B+", "C+", 100, 2)], LENGTHS)
    files = run_n_sweep(g, LENGTHS, 1, 5, 1000, 20, "pre")
    assert len(files) == 5
    best = find_optimal_n(files)
    assert best == files[0]  # n=1 keeps the full chain -> best N50


def test_sweep_prefers_higher_n_when_it_untangles(tmp_path, monkeypatch):
    """A fork at n=1 that even the ambiguity heuristics cannot resolve
    (the spur is no tip and no weak edge) blocks the A-join; n=2 drops it
    by weight and the chain forms — the sweep must pick n=2."""
    monkeypatch.chdir(tmp_path)
    lengths = {"A": 5000, "B": 6000, "C": 4000, "D": 5000}
    g = chain_graph(
        [("A+", "B+", 100, 5), ("A+", "C+", 100, 1), ("C+", "D+", 100, 5)],
        lengths,
    )
    files = run_n_sweep(g, lengths, 1, 5, 1000, 20, "pre")
    best = find_optimal_n(files)
    assert best == files[1]  # n=2

    stitch(files, g, "out.path", max_gap=-1, conservative=True)
    with open("out.path") as fh:
        lines = sorted(l.rstrip("\n").split("\t")[1] for l in fh)
    assert lines in (
        ["A+ 101N B+", "C+ 101N D+"],
        ["A+ 101N B+", "D- 101N C-"],
        ["B- 101N A-", "C+ 101N D+"],
        ["B- 101N A-", "D- 101N C-"],
    )


def test_non_conservative_stitch_grafts_terminal_edges(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # best (n=2) layout drops the weak B+->C+ edge; the alternate n=1 layout
    # still shows it end-to-end, so non-conservative mode grafts it back
    g = chain_graph([("A+", "B+", 100, 5), ("B+", "C+", 150, 1)], LENGTHS)
    files = run_n_sweep(g, LENGTHS, 1, 2, 1000, 20, "pre")
    # make n=2 the N50 winner by rigging the sweep order: feed files reversed
    # is unnecessary — craft explicit inputs instead
    with open("best.path", "w") as fh:
        fh.write("0\tA+ 101N B+\n")
    with open("best.path.sterr", "w") as fh:
        fh.write("n\tn:500\tL50\tmin\tN75\tN50\tN25\tE-size\tmax\tsum\tname\n")
        fh.write("3\t3\t1\t2000\t4000\t5000\t5000\t4000\t5000\t9000\tn=2 s=1000\n")
    with open("alt.path", "w") as fh:
        fh.write("0\tA+ 101N B+ 151N C+\n")
    with open("alt.path.sterr", "w") as fh:
        fh.write("n\tn:500\tL50\tmin\tN75\tN50\tN25\tE-size\tmax\tsum\tname\n")
        fh.write("1\t1\t1\t9000\t9000\t4999\t9000\t9000\t9000\t9000\tn=1 s=1000\n")

    stitch(["best.path", "alt.path"], g, "out.path", max_gap=-1,
           conservative=False)
    with open("out.path") as fh:
        lines = [l.rstrip("\n").split("\t")[1] for l in fh]
    assert lines == ["A+ 101N B+ 151N C+"] or lines == ["C- 151N B- 101N A-"]


def test_conservative_stitch_normalizes_and_sorts(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    g = chain_graph([("D+", "B+", 100, 5)], LENGTHS)
    with open("p.path", "w") as fh:
        fh.write("7\tD+ 101N B+\n")
    with open("p.path.sterr", "w") as fh:
        fh.write("n\tn:500\tL50\tmin\tN75\tN50\tN25\tE-size\tmax\tsum\tname\n")
        fh.write("1\t1\t1\t8000\t8000\t8000\t8000\t8000\t8000\t8000\tn=1 s=1000\n")
    stitch(["p.path"], g, "out.path", max_gap=-1, conservative=True)
    with open("out.path") as fh:
        line = fh.read().strip()
    # normalized: lexicographically smaller end first (B < D)
    assert line == "ntLink_0\tB- 101N D-"
