"""The port's scale scripts (``scripts/*_torch.py``) at tiny presets on the
CPU: the stress generator byte for byte against ``scripts/stress_scale.py``,
the whole `scaffold gap_fill` of ``stress_scale_torch.py`` against
ntlink_tpu's backend=numpy run on the same files (every join made, the
final FASTA byte-identical), the bounded run's two checks (also with the
bucket table forced into the load-4 regime), equal tally digests across
rank counts in ``measure_scaling_torch.py``, the three probes, and that
every script exits non-zero without a card unless ``--device cpu`` is
given. Each script runs as a process of its own, as a user starts it."""
import filecmp
import json
import os
import subprocess
import sys

import pytest
import torch

from ntlink_tpu import pipeline as jax_pipeline
from ntlink_tpu.config import ScaffoldConfig as JaxConfig
from ntlink_tpu_torch import mapping_step, scale

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
PRESET = ["8", "50000", "400"]  # contigs, contig length, reads
N_READS = 400
TIMEOUT_S = 300


def _script(name, *args, env=None, check=True):
    """Run ``scripts/<name>`` with `args`; returns the finished process."""
    full = {k: v for k, v in os.environ.items() if not k.startswith("NTLINK_")}
    full.update(env or {})
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", name), *args],
        env=full, capture_output=True, text=True, timeout=TIMEOUT_S)
    if check:
        assert res.returncode == 0, res.stderr[-3000:]
    return res


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def stress_run(tmp_path_factory):
    """The port's stress run on the CPU, and the JAX package's generator
    and backend=numpy `scaffold gap_fill` on its own copy of the data."""
    root = tmp_path_factory.mktemp("stress")
    port_dir, jax_dir = root / "port", root / "jax"
    res = _script("stress_scale_torch.py", str(port_dir), *PRESET,
                  "--device", "cpu")
    _script("stress_scale.py", str(jax_dir), *PRESET,
            env={"NTLINK_STRESS_GEN_ONLY": "1"})
    cfg = JaxConfig(target="target.fa", reads=["reads.fa"], k=scale.K,
                    w=scale.W, z=scale.Z, backend="numpy")
    cwd = os.getcwd()
    os.chdir(jax_dir)
    try:
        jax_final = jax_pipeline.run_scaffold(cfg, gap_fill=True)
    finally:
        os.chdir(cwd)
    return res, port_dir, jax_dir, jax_final


def test_generator_equals_stress_scale(stress_run):
    _, port_dir, jax_dir, _ = stress_run
    marker = "target.fa.gapless.8x50000.r400"
    for name in ("target.fa", "reads.fa", marker):
        assert filecmp.cmp(port_dir / name, jax_dir / name, shallow=False), \
            name
    assert os.path.getsize(port_dir / "reads.fa") == N_READS * (
        scale.READ_LEN + 1 + len(">r\n")) + sum(
        len(str(i)) for i in range(N_READS))


def test_stress_scale_joins_and_fasta_equal_ntlink_tpu(stress_run):
    res, port_dir, jax_dir, jax_final = stress_run
    out = _last_json(res.stdout)
    assert (out["joins"], out["joins_expected"]) == (7, 7)
    assert "joins made: 7/7" in res.stdout
    assert out["device"] == "cpu" and out["nvidia_smi"] is None
    assert out["mapping_reads"] == N_READS
    walls = out["stages_wall_s"]
    for stage in ("sketch_tsv", "index_parse", "table_build", "upload",
                  "mapping", "graph", "layout_stitch", "overlap", "merge",
                  "gap_fill", "total"):
        assert walls[stage] is not None and walls[stage] >= 0, stage
    assert out["table"]["minimizers"] > 0 and out["table"]["max_probes"] >= 1
    final = out["final"]
    assert os.path.basename(final) == jax_final
    assert os.path.getsize(final) > 8 * 50_000
    assert filecmp.cmp(final, jax_dir / jax_final, shallow=False)


def test_bounded_run_checks_hold(tmp_path):
    d = tmp_path / "bounded"
    _script("stress_scale_torch.py", str(d), *PRESET,
            env={"NTLINK_STRESS_GEN_ONLY": "1"})
    res = _script("stress_3g_bounded_torch.py", str(d), str(N_READS),
                  "--check-reads", str(N_READS), "--device", "cpu")
    out = _last_json(res.stdout)
    assert "OK" in res.stdout.splitlines()
    assert out["table_equal"] and out["payloads_equal"]
    assert out["payloads_checked"] == N_READS
    assert out["payloads_with_anchors"] > N_READS * 0.9
    assert out["parse"]["contigs"] == 8 and out["parse"]["minimizers"] > 0
    assert out["table"]["regime"] == "load-2"
    assert out["mapping"]["reads"] == N_READS
    assert out["sketch"]["device_rows"] == 8


def test_bounded_run_in_the_load4_regime(tmp_path, monkeypatch):
    """The same checks with the bucket table built at 4 of 8 slots a
    bucket, as a human-size index is."""
    d = str(tmp_path / "bounded4")
    scale.write_stress_dataset(d, 8, 50_000, 200)
    monkeypatch.setattr(mapping_step, "SMALL_TABLE_ENTRIES", 1_000)
    out = scale.bounded_run(d, 200, device="cpu", check_reads=200,
                            threads=2, log=lambda *a: None)
    assert out["table"]["regime"] == "load-4"
    n = out["parse"]["minimizers"]
    assert out["table"]["nb"] * mapping_step.BUCKET_LOAD >= n
    assert out["table"]["nb"] * mapping_step.BUCKET_LOAD // 2 < n
    assert out["table_equal"] and out["payloads_equal"]
    assert out["payloads_checked"] == 200


def test_bounded_run_fails_on_a_payload_that_differs(tmp_path, monkeypatch):
    """A host path that answers otherwise is caught, not passed over."""
    d = str(tmp_path / "bounded_bad")
    scale.write_stress_dataset(d, 4, 50_000, 40)
    real = scale.HostMapper.map_stream_raw

    def shifted(self, stream):
        for name, length, raw in real(self, stream):
            if raw is not None:
                raw = (raw[0], raw[1] + 1, *raw[2:])
            yield name, length, raw

    monkeypatch.setattr(scale.HostMapper, "map_stream_raw", shifted)
    with pytest.raises(scale.ScaleCheckError, match="payloads differ"):
        scale.bounded_run(d, 40, device="cpu", check_reads=40, threads=1,
                          log=lambda *a: None)


def test_measure_scaling_digests_agree(tmp_path):
    out_path = tmp_path / "scaling.json"
    res = _script("measure_scaling_torch.py", str(out_path), "--device",
                  "cpu", "--max-n", "2", "--reads", "32", "--rank-reads",
                  "80")
    with open(out_path) as fh:
        out = json.load(fh)
    assert out == _last_json(res.stdout)
    split = out["split_over_replicas"]
    assert [r["n_devices"] for r in split] == [1, 2]
    assert all(r["reads"] == 32 for r in split)
    ranks = out["multi_process_dirtransport"]
    assert [r["n_processes"] for r in ranks] == [1, 2]
    assert len({r["tally_sha"] for r in ranks}) == 1 and ranks[0]["pairs"] > 0
    assert all("shared" in r for r in split + ranks)


def test_measure_scaling_keeps_the_records(tmp_path):
    record = tmp_path / "SCALING_r05.json"
    record.write_text("{}")
    res = _script("measure_scaling_torch.py", str(record), "--device", "cpu",
                  check=False)
    assert res.returncode == 2 and record.read_text() == "{}"


@pytest.mark.parametrize("name,args", [
    ("probe_batch_torch.py", ["1", "2"]),
    ("probe_step_torch.py", ["--rows", "8", "--iters", "2"]),
    ("probe_hybrid_torch.py", ["adaptive=-1:2:0.1", "pin=0.5:2"]),
])
def test_probes_run_on_the_cpu(name, args):
    res = _script(name, *args, "--device", "cpu", "--reads", "80",
                  "--contigs", "4")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("cpu: ")]
    assert len(lines) == {"probe_batch_torch.py": 2, "probe_step_torch.py": 3,
                          "probe_hybrid_torch.py": 2}[name], res.stdout
    assert all("reads/s" in ln for ln in lines)
    if name != "probe_step_torch.py":
        assert all("pairs=" in ln and "pairs=0" not in ln for ln in lines)


def test_step_graph_probe_runs_on_the_cpu():
    """scripts/probe_step_graphs_torch.py on the CPU: the timed runs and
    the dispatch split; the steps run eagerly there, and a CPU run
    reports no device number."""
    res = _script("probe_step_graphs_torch.py", "--device", "cpu",
                  "--reads", "80", "--contigs", "4", "--runs", "2")
    out = _last_json(res.stdout)
    assert len(out["reads_per_s"]) == 2 and out["batches_per_run"] >= 1
    assert out["dispatch_ms_per_batch"] > 0
    assert 0 < out["dispatch_share_of_stream"] <= 1
    assert out["wire_stats"]["h2d"] > 0 and out["step_graphs"] is None
    assert not any(k.startswith("device_") for k in out)


def test_step_graph_probe_runs_the_hash_grid_on_the_cpu():
    """The probe's hash grid: the device named twice, the table sharded
    over a 1 x 2 grid, the steps eager on the CPU."""
    res = _script("probe_step_graphs_torch.py", "--device", "cpu",
                  "--reads", "80", "--contigs", "4", "--runs", "1",
                  "--index-sharding", "hash", "--idx-shards", "2")
    out = _last_json(res.stdout)
    assert "hash-sharded over a 1 x 2 (data, idx) grid" in out["layout"]
    assert out["batches_per_run"] >= 1 and out["dispatch_ms_per_batch"] > 0
    assert out["wire_stats"]["h2d"] > 0 and out["step_graphs"] is None


@pytest.mark.parametrize("name,args", [
    ("stress_scale_torch.py", ["{tmp}", *PRESET]),
    ("stress_3g_bounded_torch.py", ["{tmp}"]),
    ("measure_scaling_torch.py", ["{tmp}/out.json"]),
    ("probe_batch_torch.py", []),
    ("probe_step_torch.py", []),
    ("probe_hybrid_torch.py", []),
    ("probe_step_graphs_torch.py", []),
])
def test_scripts_exit_nonzero_without_a_card(tmp_path, name, args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    res = _script(name, *(a.format(tmp=tmp_path) for a in args),
                  check=False)
    assert res.returncode == 1
    assert "CUDA device" in res.stderr and "--device cpu" in res.stderr
    assert res.stdout == "" and os.listdir(tmp_path) == []


def test_phase8_script_exits_1_without_a_card():
    """scripts/smoke_phase8_torch.py runs the smoke's phase 8 on the card
    only: without one it exits 1 before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    res = _script("smoke_phase8_torch.py", check=False)
    assert res.returncode == 1
    assert "CUDA device" in res.stderr and res.stdout == ""


@pytest.mark.cuda
def test_bounded_run_on_the_card(tmp_path):
    """The bounded run's defaults: the card, both checks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = tmp_path / "card"
    _script("stress_scale_torch.py", str(d), *PRESET,
            env={"NTLINK_STRESS_GEN_ONLY": "1"})
    res = _script("stress_3g_bounded_torch.py", str(d), str(N_READS),
                  "--check-reads", str(N_READS))
    out = _last_json(res.stdout)
    assert out["table_equal"] and out["payloads_equal"]
    assert out["sketch"]["launches"] > 0 and out["mapping"]["launches"] > 0
    assert out["nvidia_smi"]
