"""What the port's command line accepts and refuses. Every setting of
``ntlink_tpu.cli`` runs (v, backend=numpy, index_sharding, idx_shards,
multi-process); only a backend name the reference does not know is
refused, and no knob silently does nothing (cli.py:131-134): v=1 turns the
tracer on, index_sharding and idx_shards are echoed and reach the mapper.
Without a card every backend but numpy exits 2."""
import os
import subprocess
import sys

import pytest

from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu_torch import cli, pipeline, tracing

from .synthetic import write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
NO_CARD = "needs a CUDA device"


def test_check_supported_accepts_tracing():
    """v=1 is accepted, like every setting but an unknown backend name."""
    pipeline.check_supported(ScaffoldConfig(target="t.fa", reads=["r.fa"],
                                            v=1))
    pipeline.check_supported(ScaffoldConfig(target="t.fa", reads=["r.fa"]))
    assert not hasattr(pipeline, "NotPorted")


@pytest.mark.parametrize("kw", [
    dict(v=1), dict(backend="numpy"), dict(backend="hybrid"),
    dict(backend="jax"), dict(index_sharding="hash"), dict(idx_shards=2),
    dict(index_sharding="hash", idx_shards=4, v=2, backend="auto"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_check_supported_accepts(kw, monkeypatch):
    monkeypatch.setenv("NTLINK_NUM_PROCESSES", "2")
    pipeline.check_supported(
        ScaffoldConfig(target="t.fa", reads=["r.fa"], **kw))


def test_check_supported_refuses_an_unknown_backend():
    with pytest.raises(ValueError, match="unknown backend=tpu"):
        pipeline.check_supported(
            ScaffoldConfig(target="t.fa", reads=["r.fa"], backend="tpu"))


def _run(tmp_path, *args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "ntlink_tpu_torch", "pair",
         "target=target.fa", "reads=reads.fa", *args],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": "",
             **(env or {})},
    )


def test_cli_with_tracing_exits_for_want_of_a_card(tmp_path):
    """v=1 is not refused: without a card the command exits 2 for want of
    the card, and says so."""
    res = _run(tmp_path, "v=1")
    assert res.returncode == 2
    assert "not yet ported" not in res.stderr
    assert NO_CARD in res.stderr


@pytest.mark.parametrize("args,env", [
    (["index_sharding=hash"], {}), (["idx_shards=2"], {}),
    ([], {"NTLINK_NUM_PROCESSES": "2", "NTLINK_GROUP_DIR": "g"}),
])
def test_cli_accepts_what_it_refused(tmp_path, args, env):
    res = _run(tmp_path, *args, env=env)
    assert res.returncode == 2
    assert "not yet ported" not in res.stderr and NO_CARD in res.stderr


def test_cli_refuses_an_unknown_backend(tmp_path):
    res = _run(tmp_path, "backend=tpu")
    assert res.returncode == 2
    assert "unknown backend=tpu" in res.stderr


def test_cli_echoes_and_enables_the_knobs(tmp_path, monkeypatch, capsys):
    """backend=numpy needs no card, so the whole of `main` runs here: v=1
    enables the tracer, and the echo shows the sharding knobs."""
    write_dataset(tmp_path, seed=47, n_reads=20)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tracing.GLOBAL, "enabled", False)
    monkeypatch.setattr(tracing.GLOBAL, "spans", [])
    rc = cli.main(["scaffold", "target=target.fa", "reads=reads.fa",
                   "backend=numpy", "v=1", "index_sharding=hash",
                   "idx_shards=2", "k=32", "w=100", "z=1000"])
    out = capsys.readouterr().out
    assert rc == 0
    assert tracing.GLOBAL.enabled
    for line in ("\tindex_sharding=hash", "\tidx_shards=2", "\tv=1",
                 "\tbackend=numpy"):
        assert line in out
    top = [s.name for s in tracing.GLOBAL.spans if s.parent is None]
    assert top[:3] == [
        "pair/contig-sketch", "pair/map-reads", "pair/graph-build"]
    assert os.path.exists("target.fa.k32.w100.z1000.trace.json")
