"""The port's `pair` stage end to end on the CPU: the DOT, pairs.tsv and
verbose_mapping artifacts are byte-identical to ntlink_tpu's pair stage
under its JAX and NumPy backends, the port never loads JAX, and its CLI
refuses to run without a CUDA device."""
import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu.pipeline import pair_stage as jax_pair_stage
from ntlink_tpu_torch.pipeline import NotPorted, pair_stage

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BASES = np.array(list("ACGT"))
PREFIX = "target.fa.k32.w100.z1000"
ARTIFACTS = (".n1.scaffold.dot", ".pairs.tsv", ".verbose_mapping.tsv")


def _write_dataset(d, seed=11):
    """A random genome cut into contigs with 500 b gaps between them, and
    reads sampled across it with 3% substitutions, half reverse-complemented
    (tests/test_synthetic_truth.py:18-44, smaller), plus a sub-k read and an
    N-containing one."""
    rng = np.random.default_rng(seed)
    pieces, contigs = [], []
    for i in range(4):
        seq = "".join(BASES[rng.integers(0, 4, 60_000)])
        contigs.append((f"contig{i}", seq))
        pieces.append(seq)
        pieces.append("".join(BASES[rng.integers(0, 4, 500)]))
    genome = "".join(pieces)
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for r in range(150):
        n = int(rng.integers(3000, 20_000))
        start = int(rng.integers(0, len(genome) - n))
        arr = np.frombuffer(genome[start : start + n].encode(), np.uint8).copy()
        pos = rng.integers(0, n, n * 3 // 100)
        arr[pos] = BASES[rng.integers(0, 4, len(pos))].astype("S1").view(
            np.uint8
        )
        seq = arr.tobytes().decode()
        if rng.random() < 0.5:
            seq = seq.translate(comp)[::-1]
        reads.append((f"r{r}", seq))
    reads.append(("short", "ACGTTGCA"))
    reads.append(("with_n", reads[0][1][:4000] + "N" + reads[0][1][4001:]))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "target.fa"), "w") as fh:
        for name, seq in contigs:
            fh.write(f">{name}\n{seq}\n")
    with open(os.path.join(d, "reads.fa"), "w") as fh:
        for name, seq in reads:
            fh.write(f">{name}\n{seq}\n")


def _cfg(**kw):
    return ScaffoldConfig(target="target.fa", reads=["reads.fa"], k=32,
                          w=100, z=1000, pairs_tsv=True, **kw)


def test_pair_artifacts_match_jax_package(tmp_path, monkeypatch):
    for side in ("torch", "jax", "numpy"):
        _write_dataset(tmp_path / side)
    monkeypatch.chdir(tmp_path / "torch")
    pair_stage(_cfg(batch_bases=200_000), device="cpu")
    for backend in ("jax", "numpy"):
        monkeypatch.chdir(tmp_path / backend)
        jax_pair_stage(_cfg(backend=backend, batch_bases=2_000_000, t=1))
    for art in ARTIFACTS:
        port = tmp_path / "torch" / f"{PREFIX}{art}"
        assert os.path.getsize(port) > 0, art
        for backend in ("jax", "numpy"):
            assert filecmp.cmp(
                port, tmp_path / backend / f"{PREFIX}{art}", shallow=False
            ), (art, backend)
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


def test_port_never_imports_jax(tmp_path):
    """The test process has JAX loaded (tests/conftest.py), so a fresh
    interpreter runs the port's CPU pair path and reports."""
    _write_dataset(tmp_path)
    code = (
        "import sys\n"
        "from ntlink_tpu.config import ScaffoldConfig\n"
        "from ntlink_tpu_torch.pipeline import pair_stage\n"
        "pair_stage(ScaffoldConfig(target='target.fa', reads=['reads.fa'],"
        " pairs_tsv=True), device='cpu')\n"
        "print('JAX_LOADED', 'jax' in sys.modules)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": REPO}, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "JAX_LOADED False" in res.stdout
    assert (tmp_path / f"{PREFIX}.n1.scaffold.dot").exists()


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
        (["scaffold", "target=t.fa", "reads=r.fa"], "not yet ported: scaffold"),
        (["pair", "target=t.fa", "reads=r.fa", "repeats=True"],
         "not yet ported: repeats=True"),
        (["pair", "target=t.fa", "reads=r.fa", "backend=hybrid"],
         "not yet ported: backend=hybrid"),
    ],
)
def test_cli_rejects_unported(argv, message, capsys):
    from ntlink_tpu_torch.cli import main

    assert main(argv) != 0
    assert message in capsys.readouterr().err


def test_pair_stage_rejects_repeats(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotPorted, match="repeats"):
        pair_stage(_cfg(repeats=True), device="cpu")
