"""The port's launchers (`ntLink_torch`, `ntLink_rounds_torch`, the
``ntlink-torch`` console script) and its command line's text against
``ntlink_tpu.cli``: the help lists every option of the JAX package's help
with its default, the parameter echo holds every line of its echo, and a
`pair` run through the launcher leaves the files that
``python -m ntlink_tpu_torch`` and ``ntlink_tpu``'s command line leave.
backend=numpy needs no card, so the whole command runs here."""
import os
import re
import subprocess
import sys

import pytest

from ntlink_tpu import cli as jax_cli
from ntlink_tpu_torch import cli

from .synthetic import assert_same_tree, write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
PAIR = ["pair", "target=target.fa", "reads=reads.fa", "k=32", "w=100",
        "z=1000", "backend=numpy", "t=2", "pairs_tsv=True"]
PREFIX = "target.fa.k32.w100.z1000"
ARTIFACTS = [PREFIX + a for a in (".n1.scaffold.dot", ".pairs.tsv",
                                  ".verbose_mapping.tsv")]


def _run(argv, cwd, **env):
    return subprocess.run(
        argv, cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **env},
    )


@pytest.mark.parametrize("launcher", ["ntLink_torch", "ntLink_rounds_torch"])
def test_launcher_prints_the_version(launcher, tmp_path):
    path = os.path.join(REPO, launcher)
    assert os.access(path, os.X_OK)
    res = _run([path, "version"], tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"ntlink-tpu v{cli.__version__}"
    assert res.stdout == _run([os.path.join(REPO, "ntLink"), "version"],
                              tmp_path).stdout


@pytest.mark.parametrize("args", [[], ["pair", "target=t.fa", "reads=r.fa"]],
                         ids=["no arguments", "no rounds target"])
def test_rounds_launcher_without_a_rounds_target_prints_help(args, tmp_path):
    res = _run([os.path.join(REPO, "ntLink_rounds_torch"), *args], tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == cli.HELP.strip()
    assert os.listdir(tmp_path) == []


def test_launcher_pair_equals_the_module_and_the_jax_package(tmp_path):
    for side in ("launcher", "module", "jax"):
        write_dataset(tmp_path / side, seed=48, n_reads=40)
    res = _run([os.path.join(REPO, "ntLink_torch"), *PAIR],
               tmp_path / "launcher")
    assert res.returncode == 0, res.stderr
    assert "device=none" in res.stdout
    res = _run([sys.executable, "-m", "ntlink_tpu_torch", *PAIR],
               tmp_path / "module", PYTHONPATH=REPO)
    assert res.returncode == 0, res.stderr
    assert_same_tree(tmp_path / "launcher", tmp_path / "module", ARTIFACTS)
    res = _run([os.path.join(REPO, "ntLink"), *PAIR], tmp_path / "jax",
               JAX_PLATFORMS="cpu")
    assert res.returncode == 0, res.stderr
    assert_same_tree(tmp_path / "launcher", tmp_path / "jax", ARTIFACTS)


def test_console_script_names_the_ports_main():
    with open(os.path.join(REPO, "setup.py")) as fh:
        text = fh.read()
    assert '"ntlink-torch=ntlink_tpu_torch.cli:main"' in text
    assert '"ntlink=ntlink_tpu.cli:main"' in text


def _options(help_text):
    """The key=value tokens of a help text from its `Required:` line on."""
    tail = help_text[help_text.index("Required:"):]
    return re.findall(r"\b\w+=\S+", tail)


def test_help_lists_every_option_of_the_jax_package(capsys):
    assert cli.main(["help"]) == 0
    out = capsys.readouterr().out
    assert out.strip() == cli.HELP.strip()
    assert cli.main([]) == 0
    assert capsys.readouterr().out == out
    want = _options(jax_cli.HELP)
    assert len(want) > 25 and "k=32" in want and "G=-1" in want
    for token in want:
        assert token in cli.HELP, token
    targets = re.findall(r"^  (\w+)", jax_cli.HELP.split("Required:")[0],
                         re.M)
    assert {"scaffold", "pair", "run_rounds", "run_rounds_gaps", "fac",
            "liftover", "clean"} <= set(targets)
    for target in targets:
        assert re.search(rf"^  {target}\b", cli.HELP, re.M), target
    for knob in ("index_sharding=replicated|hash", "idx_shards=0", "v=0",
                 "batch_bases=8000000", "NTLINK_TORCH_PROFILE=",
                 "NTLINK_TIMING=1", "NTLINK_PIPE_DEPTH=4",
                 "NTLINK_NUM_PROCESSES=", "NTLINK_PROCESS_ID=",
                 "NTLINK_GROUP_DIR=", "NTLINK_COORDINATOR=",
                 "ntLink_torch", "ntlink-torch"):
        assert knob in cli.HELP, knob
    # every default in the text is the config's
    cfg = cli.ScaffoldConfig()
    for token in _options(cli.HELP):
        key, value = token.split("=", 1)
        if hasattr(cfg, key) and re.fullmatch(r"-?\d+|True|False", value):
            assert str(getattr(cfg, key)) in (value, value + ".0"), token


def test_echo_holds_every_line_of_the_jax_packages_echo(tmp_path,
                                                        monkeypatch, capsys):
    echoes = {}
    for side, main in (("port", cli.main), ("jax", jax_cli.main)):
        write_dataset(tmp_path / side, seed=49, n_reads=20)
        monkeypatch.chdir(tmp_path / side)
        assert main(PAIR + ["g=30", "G=900", "max_n=7", "merge_gap=5",
                            "conservative=False", "soft_mask=True"]) == 0
        out = capsys.readouterr().out
        echoes[side] = [ln for ln in out.splitlines() if ln.startswith("\t")]
    assert len(echoes["jax"]) >= 23
    for line in echoes["jax"]:
        assert line in echoes["port"], line
    for line in ("\tg=30", "\tG=900", "\tmax_n=7", "\tmerge_gap=5",
                 "\tconservative=False", "\tsoft_mask=True"):
        assert line in echoes["port"]
    assert_same_tree(tmp_path / "port", tmp_path / "jax", ARTIFACTS)
