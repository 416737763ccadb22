"""backend=numpy through the port: the caller asks for the host by name,
so the contig sketch and the read mapping run on the host and no device is
resolved or touched (``torch.cuda.is_available`` and ``device.resolve`` are
patched to raise). Every artifact equals ntlink_tpu backend=numpy byte for
byte, for `pair` (verbose, PAF, pairs, with and without repeats, t=1 and
t=3) and `scaffold gap_fill`; the command line runs with no CUDA device
visible, while every other backend without a card still exits 2."""
import os
import subprocess
import sys

import pytest
import torch

from ntlink_tpu import pipeline as ref
from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu_torch import cli, device, pipeline

from .synthetic import assert_same_tree, write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
KWZ = "target.fa.k32.w100.z1000"


@pytest.fixture
def no_device(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("backend=numpy touched a device")

    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "device_count", refuse)
    monkeypatch.setattr(device, "resolve", refuse)


def _cfg(**kw):
    return ScaffoldConfig(target="target.fa", reads=["reads.fa"], k=32,
                          w=100, z=1000, backend="numpy", **kw)


@pytest.mark.parametrize("kw", [
    dict(t=1, verbose=True, paf=True, pairs_tsv=True),
    dict(t=3, verbose=True, pairs_tsv=True, repeats=True),
    dict(t=2, verbose=False, pairs_tsv=True),
], ids=["verbose-paf", "repeats-t3", "lean"])
def test_pair_matches_the_jax_package(tmp_path, monkeypatch, no_device, kw):
    for side in ("torch", "numpy"):
        write_dataset(tmp_path / side, seed=81, n_reads=100)
    monkeypatch.chdir(tmp_path / "torch")
    dot = pipeline.pair_stage(_cfg(**kw), device=device.HOST_ONLY)
    assert pipeline.last_mapper is None and pipeline.last_sketcher is None
    monkeypatch.chdir(tmp_path / "numpy")
    assert ref.pair_stage(_cfg(**kw)) == dot
    must = [dot, f"{KWZ}.pairs.tsv", "target.fa.k32.w100.tsv"]
    must += [f"{KWZ}.verbose_mapping.tsv"] if kw["verbose"] else []
    must += [f"{KWZ}.paf"] if kw.get("paf") else []
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy", must)


def test_scaffold_gap_fill_matches_the_jax_package(tmp_path, monkeypatch,
                                                   no_device):
    for side in ("torch", "numpy"):
        write_dataset(tmp_path / side, seed=82, n_reads=100)
    monkeypatch.chdir(tmp_path / "torch")
    # device=None: with backend=numpy it stands for no device as well
    final = pipeline.run_scaffold(_cfg(t=2), gap_fill=True)
    monkeypatch.chdir(tmp_path / "numpy")
    assert ref.run_scaffold(_cfg(t=2), gap_fill=True) == final
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy",
                     [final, f"{KWZ}.ntLink.scaffolds.gap_fill.fa"])


def test_numpy_backend_takes_no_device():
    with pytest.raises(ValueError, match="takes no device"):
        pipeline.split_devices(_cfg(), "cpu")
    with pytest.raises(ValueError, match="needs a device"):
        pipeline.split_devices(
            ScaffoldConfig(target="t", reads=["r"]), device.HOST_ONLY)
    with pytest.raises(ValueError, match="resolves no device"):
        device.resolve(device.HOST_ONLY)
    assert pipeline.split_devices(_cfg(), None) == (
        device.HOST_ONLY, device.HOST_ONLY)


def _cli(tmp_path, *args):
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, "-m", "ntlink_tpu_torch", "pair",
         "target=target.fa", "reads=reads.fa", "k=32", "w=100", "z=1000",
         *args],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300,
    )


def test_cli_runs_with_no_cuda_device_visible(tmp_path, monkeypatch):
    write_dataset(tmp_path / "torch", seed=83, n_reads=60)
    write_dataset(tmp_path / "numpy", seed=83, n_reads=60)
    res = _cli(tmp_path / "torch", "backend=numpy", "t=2")
    assert res.returncode == 0, res.stderr
    assert "device=none (backend=numpy runs on the host)" in res.stdout
    monkeypatch.chdir(tmp_path / "numpy")
    ref.pair_stage(_cfg(t=2))
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy",
                     [f"{KWZ}.n1.scaffold.dot", f"{KWZ}.verbose_mapping.tsv"])


@pytest.mark.parametrize("backend", ["auto", "jax", "hybrid"])
def test_other_backends_without_a_card_exit_2(tmp_path, backend):
    """No path gives way from the card to the host on its own."""
    write_dataset(tmp_path, seed=83, n_reads=10)
    res = _cli(tmp_path, f"backend={backend}")
    assert res.returncode == 2
    assert "needs a CUDA device" in res.stderr
    assert not os.path.exists(tmp_path / "target.fa.k32.w100.tsv")
