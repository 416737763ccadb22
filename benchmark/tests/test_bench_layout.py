"""A cell, a mix and a per-layer metric are found by name: adding them
takes new files and entries and no edit of the harness."""
import json
import os
import shutil

from benchmark import harness


def copy_checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"),
                root / "BENCHMARK.json")
    return root


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    root = copy_checkout(tmp_path)
    mix = json.loads((root / "benchmark/mixes/ont_r10.json").read_text())
    mix["reads"]["median"] = 20000
    (root / "benchmark/mixes/ont_r10_long.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/passes.stream.py").write_text(
        "def read(run):\n    return run.counters.get('passes')\n")
    (root / "benchmark/metrics/pack_share.stream.py").write_text(
        "def read(run):\n"
        "    s = run.counters['timing']['pack'][0]\n"
        "    return 100.0 * s / run.counters['stream_s']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({
        "name": "rice_ont_long_stream", "config": "rice_nipponbare_draft",
        "traffic": "ont_r10_long", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "read_Mbase_per_s":
            m["workloads"].append("rice_ont_long_stream")
    for name in ("passes.stream", "pack_share.stream"):
        spec["per_layer"].append({
            "name": name, "unit": "x", "better": "higher",
            "source": "program_counter", "layer": "test",
            "moves": "read_Mbase_per_s",
            "workloads": ["rice_ont_long_stream"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("rice_ont_long_stream", root=str(root))
    assert cell.mix["reads"]["median"] == 20000
    assert cell.config["name"] == "rice_nipponbare_draft"
    assert {m["name"] for m in cell.end_to_end} == {"read_Mbase_per_s",
                                                   "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"passes.stream",
                                                  "pack_share.stream"}
    assert harness.driver_for(cell.mix, str(root)).__name__.endswith(
        "stream")

    class Run:
        counters = {"passes": 7, "timing": {"pack": (2.0, 9)},
                    "stream_s": 8.0}

    assert harness.reader_for("passes.stream", str(root))(Run) == 7
    assert harness.reader_for("pack_share.stream", str(root))(Run) == 25.0


def test_every_cell_of_the_benchmark_loads():
    spec = harness.benchmark_spec()
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        harness.driver_for(cell.mix)
        for m in cell.per_layer:
            assert callable(harness.reader_for(m["name"]))
