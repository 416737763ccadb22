"""Three JAX-package flow tests that read the reference's inputs but not its
expected outputs, on `synthetic.write_dataset` drafts through the port
(backend=auto on the CPU device), each byte for byte against ntlink_tpu's
backend=numpy run: an explicit mapping checkpoint (``checkpoint=``) gives
the DOT a mapping gives (``tests/test_paf_device.py::
test_explicit_checkpoint``); sensitive chaining with the repeat filter on a
dense sketch (w=50, z=500) still joins the draft
(``tests/test_sensitive_mode.py``); and v=1 writes the overlap stage's
minimizer-graph DOT for a draft whose neighbouring contigs overlap
(``tests/test_overlap.py::test_verbose_minimizer_graph_dump``)."""
import os
import re

import numpy as np

from ntlink_tpu import pipeline as ref
from ntlink_tpu.config import ScaffoldConfig as RefConfig
from ntlink_tpu_torch import pipeline
from ntlink_tpu_torch.config import ScaffoldConfig

from .synthetic import BASES, assert_same_tree, write_dataset


def _sides(tmp_path, write):
    for side in ("torch", "numpy"):
        os.makedirs(tmp_path / side, exist_ok=True)
        write(tmp_path / side)


def test_explicit_checkpoint(tmp_path, monkeypatch):
    _sides(tmp_path, lambda d: write_dataset(d, seed=101))
    kw = dict(target="target.fa", reads=["reads.fa"], k=32, w=250, z=1000)
    monkeypatch.chdir(tmp_path / "torch")
    cfg = ScaffoldConfig(**kw)
    pipeline.pair_stage(cfg, device="cpu")
    prefix = cfg.resolved_prefix()
    os.rename(f"{prefix}.verbose_mapping.tsv", "ckpt.tsv")
    dot1 = open(f"{prefix}.n1.scaffold.dot").read()
    assert " -> " in dot1
    os.unlink(f"{prefix}.n1.scaffold.dot")

    def boom(*a, **k):
        raise AssertionError("the explicit checkpoint was not used")

    with monkeypatch.context() as m:
        m.setattr(pipeline, "map_reads", boom)
        pipeline.pair_stage(ScaffoldConfig(checkpoint="ckpt.tsv", **kw),
                            device="cpu")
    assert open(f"{prefix}.n1.scaffold.dot").read() == dot1
    monkeypatch.chdir(tmp_path / "numpy")
    ref.pair_stage(RefConfig(backend="numpy", **kw))
    os.rename(f"{prefix}.verbose_mapping.tsv", "ckpt.tsv")
    os.unlink(f"{prefix}.n1.scaffold.dot")
    ref.pair_stage(RefConfig(backend="numpy", checkpoint="ckpt.tsv", **kw))
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy",
                     ["ckpt.tsv", f"{prefix}.n1.scaffold.dot"])


def test_sensitive_dense_sketch_e2e(tmp_path, monkeypatch):
    _sides(tmp_path, lambda d: write_dataset(d, seed=102))
    kw = dict(target="target.fa", reads=["reads.fa"], k=32, w=50, z=500,
              sensitive=True, repeats=True)
    monkeypatch.chdir(tmp_path / "torch")
    cfg = ScaffoldConfig(**kw)
    final = pipeline.scaffold_stage(cfg, device="cpu")
    mapper = pipeline.last_mapper
    assert mapper.with_hashes and not mapper.prechained
    with open(f"{cfg.resolved_prefix()}.stitch.path") as fh:
        paths = [l.rstrip("\n").split("\t")[1] for l in fh]
    # denser sketch, sensitive chaining: the four contigs still join
    assert len(paths) == 1 and len(paths[0].split(" ")) == 7
    monkeypatch.chdir(tmp_path / "numpy")
    assert ref.scaffold_stage(RefConfig(backend="numpy", **kw)) == final
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy",
                     [final, f"{cfg.resolved_prefix()}.n1.scaffold.dot"])


def _overlapping_draft(d):
    """Four 40 kb contigs cut from one random genome, each overlapping the
    next by 600 b, and 120 reads of 8 kb across it."""
    rng = np.random.default_rng(103)
    genome = "".join(BASES[rng.integers(0, 4, 4 * 40_000)])
    starts = [i * 39_400 for i in range(4)]
    with open(os.path.join(d, "target.fa"), "w") as fh:
        for i, s in enumerate(starts):
            fh.write(f">ctg{i}\n{genome[s : s + 40_000]}\n")
    end = starts[-1] + 40_000
    with open(os.path.join(d, "reads.fa"), "w") as fh:
        for r in range(120):
            s = int(rng.integers(0, end - 8_000))
            fh.write(f">r{r}\n{genome[s : s + 8_000]}\n")


def test_verbose_minimizer_graph_dump(tmp_path, monkeypatch):
    """v=1 writes the reference's per-join minimizer-graph DOT
    (ntlink_overlap_sequences.py:204-244): one graph block per overlapping
    join, node labels carrying (contig, position) sightings."""
    _sides(tmp_path, _overlapping_draft)
    kw = dict(target="target.fa", reads=["reads.fa"], k=40, w=100, z=1000,
              overlap=True, merge_gap=0, v=1)
    monkeypatch.chdir(tmp_path / "torch")
    cfg = ScaffoldConfig(**kw)
    pipeline.scaffold_stage(cfg, device="cpu")
    mx_dot = f"{cfg.resolved_prefix()}.mx.dot"
    text = open(mx_dot).read()
    assert text.count("graph G {") >= 1
    assert re.search(r'\[label=".*\n\(\'\S+\', \d+\)', text)
    assert "color=lightgrey" in text
    monkeypatch.chdir(tmp_path / "numpy")
    ref.scaffold_stage(RefConfig(backend="numpy", **kw))
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy", [mx_dot])
