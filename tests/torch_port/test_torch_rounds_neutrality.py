"""Liftover neutrality through the port, after
``tests/test_rounds_neutrality.py`` and with its generators: a round-2 run
fed by the lifted checkpoint (the port's `liftover.liftover_mappings`, with
`pipeline.map_reads` made to raise) leaves the same DOT, stitch path and
final FASTA as a round-2 run that maps the reads again against round 1's
scaffolds (backend=auto on the CPU device). Round 1 itself (two
chromosomes of three contigs, verbose) and the lifted round 2 are byte for
byte ntlink_tpu's backend=numpy runs on the same input."""
import os
import shutil

import numpy as np
import pytest

from ntlink_tpu import pipeline as ref
from ntlink_tpu.config import ScaffoldConfig as RefConfig
from ntlink_tpu.liftover import liftover_mappings as ref_liftover
from ntlink_tpu_torch import pipeline
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.liftover import liftover_mappings

from test_synthetic_truth import make_genome, sample_reads

from .synthetic import assert_same_tree

ROUND1 = ("round1.fa", "round1.fa.agp", "round1.fa.verbose_mapping.tsv",
          "reads.fa")
KW = dict(k=32, w=100, z=1000, verbose=True)


def _round1(d, run, cfg):
    """Round 1 in `d` (target.fa, reads.fa there), then round 1's outputs
    under the names ntLink_rounds links."""
    cwd = os.getcwd()
    os.chdir(d)
    try:
        run(cfg)
        prefix = cfg.resolved_prefix()
        shutil.copy(os.path.realpath(cfg.out_scaffolds()), "round1.fa")
        shutil.copy(f"{prefix}.trimmed_scafs.agp", "round1.fa.agp")
        shutil.copy(f"{prefix}.verbose_mapping.tsv",
                    "round1.fa.verbose_mapping.tsv")
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def round1_dir(tmp_path_factory):
    """Round 1 over a two-chromosome genome (two multi-contig scaffolds),
    through the port and through ntlink_tpu."""
    root = tmp_path_factory.mktemp("round1")
    rng = np.random.default_rng(21)
    target, reads = [], []
    for chrom in range(2):
        genome, contigs = make_genome(rng, n_contigs=3, contig_len=200_000,
                                      gap=400)
        target += [(f"chr{chrom}_{name}", seq) for name, seq in contigs]
        reads += [(f"c{chrom}{name}", seq)
                  for name, seq in sample_reads(rng, genome, n_reads=300)]
    for side in ("torch", "numpy"):
        os.makedirs(root / side)
        with open(root / side / "target.fa", "w") as fh:
            fh.writelines(f">{n}\n{s}\n" for n, s in target)
        with open(root / side / "reads.fa", "w") as fh:
            fh.writelines(f">{n}\n{s}\n" for n, s in reads)
    kw = dict(target="target.fa", reads=["reads.fa"], **KW)
    _round1(root / "torch",
            lambda c: pipeline.run_scaffold(c, device="cpu"),
            ScaffoldConfig(**kw))
    _round1(root / "numpy", ref.run_scaffold, RefConfig(backend="numpy",
                                                        **kw))
    assert_same_tree(root / "torch", root / "numpy", ROUND1)
    # round 1 produced real joins (multi-contig scaffolds)
    headers = [l for l in open(root / "torch" / "round1.fa")
               if l.startswith(">")]
    assert len(headers) == 2, headers
    return root / "torch"


def _run_round2(src, dst, lifted, monkeypatch, port=True):
    os.makedirs(dst)
    for f in ROUND1:
        shutil.copy(os.path.join(src, f), dst)
    monkeypatch.chdir(dst)
    kw = dict(target="round1.fa", reads=["reads.fa"], **KW)
    cfg = ScaffoldConfig(**kw) if port else RefConfig(backend="numpy", **kw)
    prefix = cfg.resolved_prefix()
    if lifted:
        (liftover_mappings if port else ref_liftover)(
            "round1.fa.verbose_mapping.tsv", "round1.fa.agp",
            f"{prefix}.verbose_mapping.tsv", cfg.k)

        def boom(*a, **k):
            raise AssertionError("lifted checkpoint was not used")

        # the checkpoint must actually bypass mapping
        monkeypatch.setattr(pipeline if port else ref, "map_reads", boom)
    if port:
        pipeline.run_scaffold(cfg, device="cpu")
    else:
        ref.run_scaffold(cfg)
    monkeypatch.undo()
    return prefix


def test_lifted_round2_matches_fresh_remap(round1_dir, tmp_path,
                                           monkeypatch):
    lifted_dir = tmp_path / "lifted"
    fresh_dir = tmp_path / "fresh"
    prefix = _run_round2(round1_dir, lifted_dir, True, monkeypatch)
    _run_round2(round1_dir, fresh_dir, False, monkeypatch)
    assert pipeline.last_mapper.device_reads > 0  # the fresh run mapped
    artifacts = (f"{prefix}.n1.scaffold.dot", f"{prefix}.stitch.path",
                 "round1.fa.k32.w100.z1000.ntLink.scaffolds.fa")
    assert os.path.getsize(lifted_dir / artifacts[0]) > 0
    for artifact in artifacts:
        a, b = lifted_dir / artifact, fresh_dir / artifact
        assert open(os.path.realpath(a), "rb").read() == \
            open(os.path.realpath(b), "rb").read(), artifact
    # the lifted round 2 is ntlink_tpu's, file for file
    _run_round2(round1_dir, tmp_path / "ref_lifted", True, monkeypatch,
                port=False)
    # (the stitch path is empty: the two chromosomes stay apart)
    assert_same_tree(lifted_dir, tmp_path / "ref_lifted", artifacts[::2])
