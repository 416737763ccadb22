"""The layout-ambiguity oracle over the port's layout
(``scripts/layout_oracle_torch.py``), after ``tests/test_layout_oracle.py``:
the shipped configuration (support-weighted tips, transitive reduction
before resolution) keeps beating the flipped variants on synthetic truth
graphs, adversarial families included, and leaves clean chains untouched.
Its scores equal ``scripts/layout_oracle.py``'s (the JAX package's layout)
graph for graph on seeds 1000-1011, and the two scripts print the same
table."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import layout_oracle  # noqa: E402
import layout_oracle_torch  # noqa: E402
from layout_oracle_torch import (  # noqa: E402
    build_truth_graph, run_variant, score,
)

VARIANTS = [(True, True), (False, True), (True, False), (False, False)]
GRIDS = {
    "noise": dict(n_chimeric=10, n_tips=10, noise_n=3),
    "tandem": dict(n_chimeric=6, n_tips=4, noise_n=2, n_tandem=3),
    "chimera-0.85": dict(n_chimeric=10, n_tips=4, chimera_ratio=0.85),
    "near-tie": dict(n_chimeric=0, n_tips=0, n_neartie=10),
}


def _avg(variant_args, seeds=12, **grid):
    mis = rec = 0.0
    for s in range(seeds):
        rng = np.random.default_rng(1000 + s)
        g, truth, lengths = build_truth_graph(rng, **grid)
        m, r, _ = score(run_variant(g, lengths, *variant_args), truth, lengths)
        mis += m
        rec += r / (len(truth) / 2)
    return mis / seeds, rec / seeds


def test_shipped_variant_beats_flips():
    grid = GRIDS["noise"]
    mis_a, rec_a = _avg((True, True), **grid)    # shipped
    mis_b, rec_b = _avg((False, True), **grid)   # topological tips
    mis_c, rec_c = _avg((True, False), **grid)   # resolve before reduce
    # support-weighted tips: no more misjoins, no less recovery (ties ok)
    assert mis_a <= mis_b + 1e-9
    assert rec_a >= rec_b - 1e-9
    # reduce-first: strictly dominant
    assert mis_a < mis_c
    assert rec_a > rec_c


def test_shipped_variant_beats_flips_adversarial_families():
    """Tandem repeats with self-edges, near-true-support chimeras and
    near-tie branches do not flip the verdict."""
    for name in ("tandem", "chimera-0.85", "near-tie"):
        grid = GRIDS[name]
        mis_a, rec_a = _avg((True, True), **grid)
        mis_b, rec_b = _avg((False, True), **grid)
        assert mis_a <= mis_b + 1e-9, name
        assert rec_a >= rec_b - 1e-9, name


def test_unambiguous_graph_is_untouched():
    """On clean chains every resolution pass is a no-op regardless of the
    tip rule (golden byte parity depends on this)."""
    rng = np.random.default_rng(0)
    g, truth, lengths = build_truth_graph(
        rng, n_repeats=0, n_chimeric=0, n_tips=0, p_transitive=0.0
    )
    for st in (True, False):
        mis, rec, _ = score(run_variant(g, lengths, st, True), truth, lengths)
        assert mis == 0
        assert rec == len(truth) / 2


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_scores_equal_the_jax_packages_script(grid):
    """Per seed and variant, (misjoins, recovered, N50) of the port's
    layout equal those of the JAX package's layout on the same graph, and
    the graphs themselves are the same."""
    for s in range(12):
        port = build_truth_graph(np.random.default_rng(1000 + s),
                                 **GRIDS[grid])
        jax_side = layout_oracle.build_truth_graph(
            np.random.default_rng(1000 + s), **GRIDS[grid])
        assert port[1:] == jax_side[1:], s
        assert sorted((u, v, e.d, e.n) for u, v, e in port[0].edges()) == \
            sorted((u, v, e.d, e.n) for u, v, e in jax_side[0].edges())
        for variant in VARIANTS:
            got = score(run_variant(port[0], port[2], *variant), port[1],
                        port[2])
            want = layout_oracle.score(
                layout_oracle.run_variant(jax_side[0], jax_side[2],
                                          *variant),
                jax_side[1], jax_side[2])
            assert got == want, (s, variant)


def test_scripts_print_the_same_table():
    out = []
    for script in (layout_oracle_torch, layout_oracle):
        res = subprocess.run(
            [sys.executable, script.__file__, "--seeds", "2"],
            capture_output=True, text=True, timeout=300,
        )
        assert res.returncode == 0, res.stderr
        out.append(res.stdout)
    assert out[0] == out[1]
    assert out[0].count("\n") == 2 + 8 * 4
