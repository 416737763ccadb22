"""Two real processes of the port == one process, byte for byte.

Each case starts two ranks of the port's command line on the CPU device
over a two-file read set, each rank in a directory of its own, over the
shared-directory transport (NTLINK_GROUP_DIR) and over
``torch.distributed``/gloo (NTLINK_COORDINATOR), and compares every file
and symlink both ranks leave with the port's one-process run and with
ntlink_tpu backend=numpy on the same files: `scaffold gap_fill
verbose=True`, `pair paf=True`, and `run_rounds_gaps rounds=2` (whose
second round maps nothing). No `.part` file is left. The counterpart of
tests/test_multihost.py, on drafts made from a seed."""
import os
import shutil
import subprocess
import sys

import pytest

from ntlink_tpu import cli as ref_cli
from ntlink_tpu_torch import cli, pipeline

from .synthetic import assert_same_tree, split_reads, write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# the port's command line on the CPU device (the command line itself
# always asks for the card)
ON_CPU = """
import sys
from ntlink_tpu_torch import cli
targets, cfg, rounds = cli.parse(sys.argv[1:])
cli.dispatch(targets, cfg, rounds, "cpu")
"""
COMMON = ["target=target.fa", "reads=reads1.fa reads2.fa", "k=32", "w=100",
          "z=1000", "t=1", "batch_bases=200000"]
COMMANDS = {
    "scaffold": ["scaffold", "gap_fill", "verbose=True"] + COMMON,
    "pair": ["pair", "paf=True", "ntlink_pairs_tsv=True"] + COMMON,
    "rounds": ["run_rounds_gaps", "rounds=2"] + COMMON,
}
KWZ = "target.fa.k32.w100.z1000"
MUST = {
    "scaffold": [f"{KWZ}.verbose_mapping.tsv", f"{KWZ}.n1.scaffold.dot",
                 f"{KWZ}.ntLink.scaffolds.gap_fill.fa",
                 f"{KWZ}.trimmed_scafs.fa"],
    "pair": [f"{KWZ}.paf", f"{KWZ}.pairs.tsv", f"{KWZ}.verbose_mapping.tsv",
             f"{KWZ}.n1.scaffold.dot"],
    "rounds": [f"{KWZ}.ntLink.gap_fill.2rounds.fa",
               f"{KWZ}.ntLink.gap_fill.fa.verbose_mapping.tsv"],
}


def _setup(d):
    write_dataset(d, seed=71, n_reads=120)
    split_reads(d)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """command -> directory of the port's one-process run on the CPU, held
    against ntlink_tpu backend=numpy on the same files."""
    root = tmp_path_factory.mktemp("single")
    out = {}
    cwd = os.getcwd()
    for name, argv in COMMANDS.items():
        port_dir, ref_dir = root / name / "port", root / name / "numpy"
        _setup(port_dir)
        _setup(ref_dir)
        try:
            os.chdir(port_dir)
            targets, cfg, rounds = cli.parse(argv)
            cli.dispatch(targets, cfg, rounds, "cpu")
            assert pipeline.last_mapper.device_reads > 100
            os.chdir(ref_dir)
            assert ref_cli.main(argv + ["backend=numpy"]) == 0
        finally:
            os.chdir(cwd)
        assert_same_tree(port_dir, ref_dir, MUST[name])
        out[name] = port_dir
    return out


def _ranks(tmp_path, argv, transport):
    """Run two ranks to their end; returns their directories."""
    base_env = {k: v for k, v in os.environ.items()
                if not k.startswith("NTLINK_")}
    base_env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                    NTLINK_NUM_PROCESSES="2")
    for attempt in range(2):  # gloo: the free port can be taken meanwhile
        if transport == "dir":
            group = {"NTLINK_GROUP_DIR": str(tmp_path / "group")}
        else:
            group = {"NTLINK_COORDINATOR": f"127.0.0.1:{_free_port()}"}
        dirs, procs = [], []
        for pid in range(2):
            d = tmp_path / f"rank{pid}"
            if d.exists():
                shutil.rmtree(d)
            _setup(d)
            dirs.append(d)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", ON_CPU, *argv], cwd=d,
                env={**base_env, **group, "NTLINK_PROCESS_ID": str(pid)},
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        outs = [p.communicate(timeout=600)[0] for p in procs]
        if all(p.returncode == 0 for p in procs):
            break
        assert attempt == 0 and transport == "gloo", \
            [o[-3000:] for o in outs]
    # each rank mapped one of the two files
    for pid, out in enumerate(outs):
        assert f"Host {pid}/2 mapping reads{pid + 1}.fa" in out
        assert f"Host {pid}/2 mapping reads{2 - pid}.fa" not in out
    return dirs


@pytest.mark.parametrize("transport", ["dir", "gloo"])
@pytest.mark.parametrize("command", ["scaffold", "pair"])
def test_two_ranks_match_one_process(tmp_path, single, command, transport):
    for d in _ranks(tmp_path, COMMANDS[command], transport):
        names = assert_same_tree(d, single[command], MUST[command])
        assert not [n for n in names if ".part" in n]


def test_two_ranks_run_rounds_gaps(tmp_path, single):
    for d in _ranks(tmp_path, COMMANDS["rounds"], "dir"):
        names = assert_same_tree(d, single["rounds"], MUST["rounds"])
        assert not [n for n in names if ".part" in n]
