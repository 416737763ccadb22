"""backend=hybrid through the port on the CPU device: the `pair` stage with
the TorchMapper and the host's C path behind one HybridMapper, adaptive
(hybrid_host_frac=-1) and pinned (0.5), verbose and not, byte for byte
against ntlink_tpu's backend=numpy pair stage; and TorchHybridSketcher's
contig TSV against ntlink_tpu's host sketcher. Inputs come from numpy
seeds; every comparison is exact."""
import filecmp
import os

import numpy as np
import pytest

from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu.hybrid_map import BLOCK_READS
from ntlink_tpu.pipeline import pair_stage as jax_pair_stage
from ntlink_tpu.sketch import sketch_fasta_to_tsv
from ntlink_tpu_torch import pipeline
from ntlink_tpu_torch.sketch import TorchHybridSketcher

from .synthetic import write_dataset

PREFIX = "target.fa.k32.w100.z1000"
ARTIFACTS = (".n1.scaffold.dot", ".pairs.tsv", ".verbose_mapping.tsv")
CONTIG_TSV = "target.fa.k32.w100.tsv"
# past one HybridMapper block of reads, so that both paths get blocks
N_READS = BLOCK_READS + 100


def _cfg(**kw):
    return ScaffoldConfig(target="target.fa", reads=["reads.fa"], k=32,
                          w=100, z=1000, pairs_tsv=True, **kw)


@pytest.mark.parametrize("verbose", [True, False])
@pytest.mark.parametrize("host_frac", [-1.0, 0.5])
def test_pair_hybrid_matches_numpy_backend(tmp_path, monkeypatch, verbose,
                                           host_frac):
    for side in ("torch", "numpy"):
        write_dataset(tmp_path / side, seed=15, n_reads=N_READS,
                      read_len=(1000, 3000))
    monkeypatch.chdir(tmp_path / "torch")
    pipeline.pair_stage(
        _cfg(backend="hybrid", t=2, hybrid_host_frac=host_frac,
             batch_bases=400_000, verbose=verbose),
        device="cpu",
    )
    hybrid, mapper = pipeline.last_hybrid, pipeline.last_mapper
    assert hybrid is not None and hybrid.device is mapper
    assert isinstance(pipeline.last_sketcher, TorchHybridSketcher)
    assert hybrid.runs_only == (not verbose) and hybrid.prechained
    assert hybrid.host_frac == host_frac
    # which path delivers a read depends on timing (a path quiet for
    # STALL_RESCUE_S has its reads re-run on the other), so only the sum
    # of the attribution is fixed
    assert hybrid.device_reads + hybrid.host_reads == N_READS + 2
    monkeypatch.chdir(tmp_path / "numpy")
    jax_pair_stage(_cfg(backend="numpy", t=1, verbose=verbose))
    arts = [PREFIX + a for a in ARTIFACTS[: 3 if verbose else 2]]
    for art in arts + [CONTIG_TSV]:
        port = tmp_path / "torch" / art
        assert os.path.getsize(port) > 0, art
        assert filecmp.cmp(port, tmp_path / "numpy" / art, shallow=False), art
    assert (tmp_path / "torch" / f"{PREFIX}{ARTIFACTS[2]}").exists() == verbose


def test_hybrid_sketcher_tsv_matches_host(tmp_path):
    """300 contigs, some with N runs, some sub-k: more than one block of
    the hybrid sketcher, so with a pinned half share both paths get
    blocks."""
    rng = np.random.default_rng(16)
    with open(tmp_path / "draft.fa", "w") as fh:
        for i in range(300):
            seq = np.array(list("ACGT"))[rng.integers(0, 4,
                                                      rng.integers(20, 6000))]
            if i % 7 == 0:
                seq[len(seq) // 3 : len(seq) // 3 + 50] = "N"
            fh.write(f">c{i}\n{''.join(seq)}\n")
    sk = TorchHybridSketcher("cpu", threads=2, host_frac=0.5)
    sketch_fasta_to_tsv(str(tmp_path / "draft.fa"), str(tmp_path / "port.tsv"),
                        32, 100, backend=sk)
    sketch_fasta_to_tsv(str(tmp_path / "draft.fa"), str(tmp_path / "host.tsv"),
                        32, 100, backend=None)
    assert filecmp.cmp(tmp_path / "port.tsv", tmp_path / "host.tsv",
                       shallow=False)
    assert sk.host_seqs + sk.device_seqs == 300
