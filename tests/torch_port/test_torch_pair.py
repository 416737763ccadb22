"""The port's `pair` stage end to end on the CPU: the contig sketch TSV, DOT,
pairs.tsv and verbose_mapping artifacts are byte-identical to ntlink_tpu's
pair stage under its JAX and NumPy backends, in the default (verbose,
prechained) run and in the lean (runs-only) run, and with PAF output; the
port never loads JAX, and its CLI refuses to run without a CUDA device."""
import filecmp
import os
import subprocess
import sys

import pytest

from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu.pipeline import pair_stage as jax_pair_stage
from ntlink_tpu_torch import pipeline
from ntlink_tpu_torch.pipeline import pair_stage

from .synthetic import write_dataset as _write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
PREFIX = "target.fa.k32.w100.z1000"
ARTIFACTS = (".n1.scaffold.dot", ".pairs.tsv", ".verbose_mapping.tsv")
CONTIG_TSV = "target.fa.k32.w100.tsv"


def _cfg(**kw):
    return ScaffoldConfig(target="target.fa", reads=["reads.fa"], k=32,
                          w=100, z=1000, pairs_tsv=True, **kw)


def test_pair_artifacts_match_jax_package(tmp_path, monkeypatch):
    for side in ("torch", "jax", "numpy"):
        _write_dataset(tmp_path / side)
    monkeypatch.chdir(tmp_path / "torch")
    pair_stage(_cfg(batch_bases=200_000), device="cpu")
    last_mapper, last_sketcher = pipeline.last_mapper, pipeline.last_sketcher
    for backend in ("jax", "numpy"):
        monkeypatch.chdir(tmp_path / backend)
        jax_pair_stage(_cfg(backend=backend, batch_bases=2_000_000, t=1))
    for art in [PREFIX + a for a in ARTIFACTS] + [CONTIG_TSV]:
        port = tmp_path / "torch" / art
        assert os.path.getsize(port) > 0, art
        for backend in ("jax", "numpy"):
            assert filecmp.cmp(
                port, tmp_path / backend / art, shallow=False
            ), (art, backend)
    assert last_mapper.prechained and not last_mapper.runs_only
    assert any(has_n for _, has_n in last_mapper.batches_by_pad)
    assert any(has_n for _, has_n in last_sketcher.batches_by_pad)
    # a rerun without the DOT tallies from the verbose mapping checkpoint
    # (no device work) and writes the same bytes
    monkeypatch.chdir(tmp_path / "torch")
    for art in ARTIFACTS[:2]:
        os.unlink(f"{PREFIX}{art}")
    pair_stage(_cfg(batch_bases=200_000), device="cpu")
    for art in ARTIFACTS[:2]:
        assert filecmp.cmp(
            f"{PREFIX}{art}", tmp_path / "numpy" / f"{PREFIX}{art}",
            shallow=False,
        ), art


def test_pair_runs_only_matches_jax_package(tmp_path, monkeypatch):
    """verbose=False: the port's mapper ships O(runs) payloads (prechained,
    runs_only), ntlink_tpu's backend=jax DeviceMapper does too, and the
    NumPy backend chains every read on the host; DOT, pairs.tsv and the
    contig TSV are the same bytes on all three."""
    for side in ("torch", "jax", "numpy"):
        _write_dataset(tmp_path / side, seed=12)
    monkeypatch.chdir(tmp_path / "torch")
    pair_stage(_cfg(batch_bases=200_000, verbose=False), device="cpu")
    assert pipeline.last_mapper.prechained and pipeline.last_mapper.runs_only
    for backend in ("jax", "numpy"):
        monkeypatch.chdir(tmp_path / backend)
        jax_pair_stage(_cfg(backend=backend, batch_bases=2_000_000, t=1,
                            verbose=False))
    for art in [PREFIX + a for a in ARTIFACTS[:2]] + [CONTIG_TSV]:
        port = tmp_path / "torch" / art
        assert os.path.getsize(port) > 0, art
        for backend in ("jax", "numpy"):
            assert filecmp.cmp(
                port, tmp_path / backend / art, shallow=False
            ), (art, backend)
    assert not (tmp_path / "torch" / f"{PREFIX}{ARTIFACTS[2]}").exists()


def test_port_never_imports_jax(tmp_path):
    """The test process has JAX loaded (tests/conftest.py), so a fresh
    interpreter runs the port's CPU pair path, the default run and the
    runs-only one, and reports."""
    _write_dataset(tmp_path)
    code = (
        "import sys\n"
        "from ntlink_tpu.config import ScaffoldConfig\n"
        "from ntlink_tpu_torch import pipeline\n"
        "pipeline.pair_stage(ScaffoldConfig(target='target.fa',"
        " reads=['reads.fa'], pairs_tsv=True), device='cpu')\n"
        "pipeline.pair_stage(ScaffoldConfig(target='target.fa',"
        " reads=['reads.fa'], verbose=False, prefix='lean'), device='cpu')\n"
        "print('RUNS_ONLY', pipeline.last_mapper.runs_only)\n"
        "print('JAX_LOADED', 'jax' in sys.modules)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": REPO}, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "JAX_LOADED False" in res.stdout
    assert "RUNS_ONLY True" in res.stdout
    assert (tmp_path / f"{PREFIX}.n1.scaffold.dot").exists()
    assert (tmp_path / "lean.n1.scaffold.dot").exists()


def test_cli_without_cuda_exits_nonzero(tmp_path):
    _write_dataset(tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "ntlink_tpu_torch", "pair",
         "target=target.fa", "reads=reads.fa"],
        cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""},
        timeout=300,
    )
    assert res.returncode != 0
    assert "CUDA" in res.stderr
    assert not (tmp_path / f"{PREFIX}.n1.scaffold.dot").exists()


@pytest.mark.parametrize(
    "argv,message",
    [
        (["pair", "target=t.fa", "reads=r.fa", "index_sharding=hash"],
         "not yet ported: index_sharding=hash"),
        (["scaffold", "target=t.fa", "reads=r.fa", "v=1"],
         "not yet ported: v (tracing)"),
        (["pair", "target=t.fa", "reads=r.fa", "backend=numpy"],
         "python -m ntlink_tpu ... backend=numpy"),
    ],
)
def test_cli_rejects_unported(argv, message, capsys):
    from ntlink_tpu_torch.cli import main

    assert main(argv) != 0
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("verbose", [True, False])
def test_pair_paf_matches_jax_package(tmp_path, monkeypatch, verbose):
    """paf=True: per-anchor payloads (prechained; no runs-only payload,
    PAF needs the anchors), with and without the verbose mapping; the PAF,
    DOT and pairs.tsv are ntlink_tpu's backend=numpy bytes."""
    for side in ("torch", "numpy"):
        _write_dataset(tmp_path / side, seed=13)
    monkeypatch.chdir(tmp_path / "torch")
    pair_stage(_cfg(batch_bases=200_000, paf=True, verbose=verbose),
               device="cpu")
    assert pipeline.last_mapper.prechained
    assert not pipeline.last_mapper.runs_only
    monkeypatch.chdir(tmp_path / "numpy")
    jax_pair_stage(_cfg(backend="numpy", t=1, paf=True, verbose=verbose))
    arts = [PREFIX + a for a in (".paf",) + ARTIFACTS[: 3 if verbose else 2]]
    for art in arts:
        port = tmp_path / "torch" / art
        assert os.path.getsize(port) > 0, art
        assert filecmp.cmp(port, tmp_path / "numpy" / art, shallow=False), art
    assert (tmp_path / "torch" / f"{PREFIX}{ARTIFACTS[2]}").exists() == verbose
