"""The scaffold flows and the host targets through the port on the CPU
device: `scaffold [gap_fill]`, `run_rounds` and `run_rounds_gaps rounds=2`
leave the same directory as ntlink_tpu's backend=numpy flows (every file
byte for byte, every symlink to the same name: each round's scaffold
FASTA, AGP, gap-filled FASTA and verbose_mapping, and the final
`*.2rounds.fa`); `fac`, `liftover`, `clean` and `version` through the
port's CLI print and write what ``ntlink_tpu.cli`` does; the rounds
targets alone take rounds=; and none of these flows loads JAX. Inputs
come from numpy seeds; every comparison is exact."""
import os
import shutil
import subprocess
import sys

import pytest

from ntlink_tpu import cli as host_cli
from ntlink_tpu import pipeline as ref
from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu_torch import cli, pipeline

from .synthetic import (
    assert_same_tree, write_dataset, write_rounds_dataset,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
KWZ = "k32.w100.z1000"


def _cfg(**kw):
    return ScaffoldConfig(target="target.fa", reads=["reads.fa"], k=32,
                          w=100, z=1000, t=1, **kw)


def _both(tmp_path, monkeypatch, seed, port_fn, ref_fn):
    """Run `port_fn` and `ref_fn` on the same dataset in two directories."""
    for side in ("torch", "numpy"):
        write_dataset(tmp_path / side, seed=seed)
    monkeypatch.chdir(tmp_path / "torch")
    port_out = port_fn()
    monkeypatch.chdir(tmp_path / "numpy")
    ref_out = ref_fn()
    assert port_out == ref_out
    return port_out


@pytest.mark.parametrize("gap_fill", [False, True])
def test_scaffold_matches_numpy_backend(tmp_path, monkeypatch, gap_fill):
    final = _both(
        tmp_path, monkeypatch, 21,
        lambda: pipeline.run_scaffold(_cfg(batch_bases=200_000),
                                      gap_fill=gap_fill, device="cpu"),
        lambda: ref.run_scaffold(_cfg(backend="numpy"), gap_fill=gap_fill),
    )
    stem = f"target.fa.{KWZ}"
    must = [final, f"{stem}.verbose_mapping.tsv", f"{stem}.n1.scaffold.dot",
            f"{stem}.trimmed_scafs.agp",
            f"target.fa.{KWZ}.stitch.abyss-scaffold.fa"]
    if gap_fill:
        must += [f"{stem}.ntLink.scaffolds.gap_fill.fa",
                 f"{stem}.ntLink.scaffolds.gap_fill.fa.agp"]
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy", must)
    assert os.path.islink(tmp_path / "torch" / f"{stem}.ntLink.scaffolds.fa")


@pytest.mark.parametrize("gap_fill", [False, True])
def test_run_rounds_matches_numpy_backend(tmp_path, monkeypatch, gap_fill):
    final = _both(
        tmp_path, monkeypatch, 22,
        lambda: pipeline.run_rounds(_cfg(batch_bases=200_000), 2,
                                    gap_fill=gap_fill, device="cpu"),
        lambda: ref.run_rounds(_cfg(backend="numpy"), 2, gap_fill=gap_fill),
    )
    suffix = "ntLink.gap_fill" if gap_fill else "ntLink"
    r1 = f"target.fa.{KWZ}.{suffix}.fa"
    r2 = f"target.fa.{KWZ}.ntLink.{suffix}.fa"
    assert final == f"target.fa.{KWZ}.{suffix}.2rounds.fa"
    must = [final, r1, r2]
    for rnd in (r1, r2):
        must += [f"{rnd}.agp", f"{rnd}.verbose_mapping.tsv"]
    if gap_fill:
        must += [f"target.fa.{KWZ}.ntLink.2rounds.fa",
                 f"{r1}.{KWZ}.ntLink.scaffolds.gap_fill.fa"]
    names = assert_same_tree(tmp_path / "torch", tmp_path / "numpy", must)
    # round 2 consumed the lifted mapping of round 1: no second mapping
    assert f"{r1}.{KWZ}.verbose_mapping.tsv" in names
    assert len(pipeline.round_launches) == 2



def _n_records(path):
    with open(path) as fh:
        return sum(line.startswith(">") for line in fh)


@pytest.mark.parametrize("rounds", [2, 3])
@pytest.mark.parametrize("gap_fill", [False, True])
def test_later_rounds_that_join_match_numpy_backend(tmp_path, monkeypatch,
                                                    gap_fill, rounds):
    """`run_rounds` / `run_rounds_gaps` on a draft whose later rounds still
    make joins (`write_rounds_dataset`): the lifted mapping of each round
    feeds joins of the next, and the whole tree is the reference's."""
    for side in ("torch", "numpy"):
        write_rounds_dataset(tmp_path / side)
    monkeypatch.chdir(tmp_path / "torch")
    final = pipeline.run_rounds(_cfg(batch_bases=200_000), rounds,
                                gap_fill=gap_fill, device="cpu")
    monkeypatch.chdir(tmp_path / "numpy")
    assert ref.run_rounds(_cfg(backend="numpy"), rounds,
                          gap_fill=gap_fill) == final
    suffix = "ntLink.gap_fill" if gap_fill else "ntLink"
    outs = [f"target.fa.{KWZ}.{'ntLink.' * r}{suffix}.fa"
            for r in range(rounds)]
    assert final == f"target.fa.{KWZ}.{suffix}.{rounds}rounds.fa"
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy",
                     [final] + outs + [f"{o}.agp" for o in outs])
    # the reference's round 2 joined scaffolds that round 1 left apart
    n1, n2 = (_n_records(tmp_path / "numpy" / o) for o in outs[:2])
    assert n2 < n1
    assert len(pipeline.round_launches) == rounds


def _cli_both(tmp_path, capsys, argv):
    """`argv` through the port's CLI and through ntlink_tpu's, each in its
    own copy of the directory; returns the two stdouts."""
    outs = []
    for side, main in (("torch", cli.main), ("numpy", host_cli.main)):
        os.chdir(tmp_path / side)
        assert main(list(argv)) == 0
        outs.append(capsys.readouterr().out)
    return outs


def test_host_targets_match_ntlink_tpu_cli(tmp_path, monkeypatch, capsys):
    write_dataset(tmp_path / "torch", seed=23)
    monkeypatch.chdir(tmp_path / "torch")
    ref.run_scaffold(_cfg(backend="numpy"))
    shutil.copytree(tmp_path / "torch", tmp_path / "numpy", symlinks=True)
    capsys.readouterr()
    stem = f"target.fa.{KWZ}"

    port_out, ref_out = _cli_both(tmp_path, capsys, ["version"])
    assert port_out == ref_out and "ntlink-tpu v" in port_out
    port_out, ref_out = _cli_both(
        tmp_path, capsys, ["fac", "target.fa", f"{stem}.ntLink.scaffolds.fa"])
    assert port_out == ref_out and port_out.count("\n") == 3
    _cli_both(tmp_path, capsys, [
        "liftover", f"agp={stem}.trimmed_scafs.agp",
        f"mappings={stem}.verbose_mapping.tsv", "out=lifted.tsv", "k=32",
    ])
    _cli_both(tmp_path, capsys, ["clean", "target=target.fa",
                                 "reads=reads.fa", "k=32", "w=100", "z=1000"])
    names = assert_same_tree(tmp_path / "torch", tmp_path / "numpy",
                             ["lifted.tsv"])
    assert "target.fa.k32.w100.tsv" not in names
    assert f"{stem}.stitch.path" not in names


def test_rounds_knob_only_for_rounds_targets(capsys):
    targets, _, rounds = cli.parse(["run_rounds_gaps", "target=t.fa",
                                    "reads=r.fa", "rounds=2"])
    assert (targets, rounds) == (["run_rounds_gaps"], 2)
    assert cli.parse(["run_rounds", "target=t.fa", "reads=r.fa"])[2] == 5
    with pytest.raises(SystemExit, match="rounds= is not valid"):
        cli.parse(["scaffold", "target=t.fa", "reads=r.fa", "rounds=2"])
    # a device target without a card exits 2 before any work
    assert cli.main(["run_rounds_gaps", "target=t.fa", "reads=r.fa",
                     "rounds=2"]) == 2
    assert "CUDA" in capsys.readouterr().err


def test_flows_never_import_jax(tmp_path):
    """The test process has JAX loaded (tests/conftest.py), so a fresh
    interpreter runs the port's rounds flow with gap-fill, a hybrid `pair`
    and the host targets through the port's CLI, and reports."""
    write_dataset(tmp_path, seed=24, n_reads=60)
    code = (
        "import sys\n"
        "from ntlink_tpu.config import ScaffoldConfig\n"
        "from ntlink_tpu_torch import cli, pipeline\n"
        "cfg = ScaffoldConfig(target='target.fa', reads=['reads.fa'], t=2)\n"
        "pipeline.run_rounds(cfg, 2, gap_fill=True, device='cpu')\n"
        "pipeline.pair_stage(ScaffoldConfig(target='target.fa',"
        " reads=['reads.fa'], backend='hybrid', t=2, prefix='hyb'),"
        " device='cpu')\n"
        "assert cli.main(['fac', 'target.fa']) == 0\n"
        "assert cli.main(['version']) == 0\n"
        "print('HYBRID', pipeline.last_hybrid is not None)\n"
        "print('JAX_LOADED', 'jax' in sys.modules)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stderr
    assert "HYBRID True" in res.stdout
    assert "JAX_LOADED False" in res.stdout
    assert (tmp_path / f"target.fa.{KWZ}.ntLink.gap_fill.2rounds.fa").exists()
