"""``ntlink_tpu_torch`` is a package of its own: nothing in it, nor in the
scripts and launchers that drive it, imports ``jax``, ``ntlink_tpu`` or the
repository's root ``bench`` module (the port's bench keeps its own copy of
what it needs from it)."""
import ast
import os
import subprocess
import sys

import pytest

from .synthetic import write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
PACKAGE = os.path.join(REPO, "ntlink_tpu_torch")
SCRIPTS = ("chip_smoke.py", "ntLink_torch", "ntLink_rounds_torch") + tuple(
    os.path.join("scripts", name) for name in (
        "profile_pair_torch.py", "stress_3g_bounded_torch.py",
        "stress_scale_torch.py", "measure_scaling_torch.py",
        "probe_batch_torch.py", "probe_step_torch.py",
        "probe_hybrid_torch.py", "layout_oracle_torch.py",
        "probe_step_graphs_torch.py", "smoke_phase8_torch.py"))
FORBIDDEN = ("jax", "ntlink_tpu", "bench")


def _sources():
    for root, _, files in os.walk(PACKAGE):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    for name in SCRIPTS:
        yield os.path.join(REPO, name)


def _forbidden_imports(path):
    """(line, module) of every import in `path` whose top-level package is
    forbidden; a relative import stays inside its own package."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in FORBIDDEN]
    return found


def test_sources_found():
    paths = list(_sources())
    assert len(paths) > 39
    assert all(os.path.exists(p) for p in paths)
    for sub in ("native", "seqio", "ops", "parallel"):
        assert any(os.sep + sub + os.sep in p for p in paths)
    rels = {os.path.relpath(p, PACKAGE) for p in paths}
    assert {"graft_entry.py", os.path.join("parallel", "distributed.py"),
            os.path.join("parallel", "sharded_index.py"),
            os.path.join("parallel", "__init__.py"), "bench.py",
            os.path.join("..", "ntLink_torch"),
            os.path.join("..", "ntLink_rounds_torch")} <= rels


@pytest.mark.parametrize("rel", sorted(
    os.path.relpath(p, REPO) for p in _sources()))
def test_no_import_of_jax_or_the_jax_package(rel):
    assert _forbidden_imports(os.path.join(REPO, rel)) == []


def test_guard_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import os\n"
        "def f():\n"
        "    from ntlink_tpu.config import ScaffoldConfig\n"
        "    import jax.numpy as jnp\n"
        "from ntlink_tpu_torch import cli\n"
        "from . import ntlink_tpu\n"
        "from . import bench\n"
        "from ntlink_tpu_torch import bench\n"
        "import bench\n"
        "from bench import make_dataset\n"
    )
    assert sorted(_forbidden_imports(str(bad))) == [(3, "ntlink_tpu.config"),
                                            (4, "jax.numpy"), (9, "bench"),
                                            (10, "bench")]


BLOCKED_RUN = """
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ntlink_tpu"):
            raise ImportError("refused in this test: " + name)

sys.meta_path.insert(0, Refuse())
import ntlink_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    ntlink_tpu_torch.__path__, "ntlink_tpu_torch.")]
for name in names:
    if not name.endswith("__main__"):
        importlib.import_module(name)
print("IMPORTED", len(names))

# `python -m ntlink_tpu_torch pair ...` as the command line runs it, on the
# CPU: the command line itself always asks for the card
from ntlink_tpu_torch import cli
argv = ["pair", "target=target.fa", "reads=reads.fa", "k=32", "w=100",
        "z=1000", "t=2"]
targets, cfg, rounds = cli.parse(argv)
print("DOT", cli.dispatch(targets, cfg, rounds, "cpu"))
assert cli.main(["fac", "target.fa"]) == 0
assert cli.main(["pair", "target=target.fa", "reads=reads.fa"]) == 2
# the new paths: two devices, the hash-sharded index, the dryruns
from ntlink_tpu_torch import graft_entry
cfg.index_sharding = "hash"
import os
os.remove("target.fa.k32.w100.z1000.n1.scaffold.dot")
print("DOT2", cli.dispatch(targets, cfg, rounds, ["cpu", "cpu"]))
graft_entry.dryrun_multichip(2, devices=["cpu"] * 2)
# a single-process run starts no process group (`import torch` loads
# torch.distributed by itself; the port's own import of it is lazy)
import torch.distributed
print("DIST", torch.distributed.is_initialized())
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "ntlink_tpu")))
"""


def test_port_runs_with_jax_and_the_jax_package_refused(tmp_path):
    """A fresh interpreter whose import system refuses `jax` and
    `ntlink_tpu` imports every module of the port and runs `pair` on the
    CPU on a small draft."""
    write_dataset(tmp_path, seed=46, n_reads=60)
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout
    assert "DIST False" in res.stdout
    assert "DOT2 target.fa.k32.w100.z1000.n1.scaffold.dot" in res.stdout
    imported = int(res.stdout.split("IMPORTED ")[1].split()[0])
    assert imported > 30
    dot = tmp_path / "target.fa.k32.w100.z1000.n1.scaffold.dot"
    assert f"DOT {dot.name}" in res.stdout
    assert " -> " in dot.read_text()
