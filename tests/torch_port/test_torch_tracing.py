"""The port's tracer (`tracing`, v=1) against ntlink_tpu's: the span names
and their order for `scaffold gap_fill v=1`, the stage report and
`<prefix>.trace.json`, artifacts that do not change with v, and the
``torch.profiler`` hook: NTLINK_TORCH_PROFILE writes one Chrome trace per
stage, the `pair/map-reads` trace holds the `record_function` ranges of
`mapping_step` and `chain`, and a profile directory that cannot be written
raises instead of being skipped."""
import io
import json
import os

import pytest

from ntlink_tpu import pipeline as ref
from ntlink_tpu import tracing as ref_tracing
from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu_torch import chain, mapping_step, pipeline, tracing

from .synthetic import assert_same_tree, write_dataset

KWZ = "target.fa.k32.w100.z1000"
SPANS = ["pair/contig-sketch", "pair/map-reads", "pair/graph-build",
         "layout+stitch", "overlap-trim", "merge", "gap-fill"]
TABLE = ["table/build", "table/upload"]


def _cfg(**kw):
    return ScaffoldConfig(target="target.fa", reads=["reads.fa"], k=32,
                          w=100, z=1000, t=1, batch_bases=200_000, **kw)


@pytest.fixture
def tracers(monkeypatch):
    """Both packages' process-wide tracers, enabled and empty, put back
    afterwards."""
    for mod in (tracing, ref_tracing):
        monkeypatch.setattr(mod.GLOBAL, "enabled", True)
        monkeypatch.setattr(mod.GLOBAL, "spans", [])
    monkeypatch.setattr(tracing.GLOBAL, "torch_profile_dir", None)
    monkeypatch.setattr(ref_tracing.GLOBAL, "jax_profile_dir", None)
    return tracing.GLOBAL, ref_tracing.GLOBAL


def test_spans_match_the_jax_package(tmp_path, monkeypatch, tracers):
    port_tracer, ref_tracer = tracers
    for side in ("traced", "plain", "numpy"):
        write_dataset(tmp_path / side, seed=91, n_reads=80)
    monkeypatch.chdir(tmp_path / "traced")
    pipeline.run_scaffold(_cfg(v=1), gap_fill=True, device="cpu")
    monkeypatch.chdir(tmp_path / "numpy")
    ref.run_scaffold(_cfg(v=1, backend="numpy"), gap_fill=True)
    # the port's top-level spans are the JAX package's; its own spans nest
    # in them: the contig index's in the contig sketch, and the contig
    # table's in the read mapping, where the JAX package builds its mapper
    names = [s.name for s in port_tracer.spans if s.parent is None]
    assert names == [s.name for s in ref_tracer.spans] == SPANS
    parents = {s.name: s.parent for s in port_tracer.spans if s.parent}
    assert parents == {
        **{n: "pair/contig-sketch" for n in (
            "contig-sketch/render", "index/read", "index/parse",
            "index/dedup")},
        **{n: "pair/map-reads" for n in TABLE}}
    # the report and the JSON, as ntlink_tpu writes them, the nested spans
    # indented under theirs in the report
    reports = []
    for t in (port_tracer, ref_tracer):
        buf = io.StringIO()
        t.report(buf)
        reports.append([line[:31] for line in buf.getvalue().splitlines()
                        if not line.startswith("    ")])
    assert reports[0] == reports[1]
    assert reports[0][:2] == ["", "Stage trace:"]
    assert reports[0][2:] == [f"  {name:<24} wall" for name in SPANS + ["TOTAL"]]
    with open(tmp_path / "traced" / f"{KWZ}.trace.json") as fh:
        spans = json.load(fh)
    with open(tmp_path / "numpy" / f"{KWZ}.trace.json") as fh:
        ref_spans = json.load(fh)
    top = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in top] == SPANS
    # the JAX package's fields, and beside them start_ns, parent, thread
    assert [sorted(s) for s in top] == [
        sorted(list(s) + ["parent", "start_ns", "thread"]) for s in ref_spans]
    assert all(s["wall_s"] >= 0 and s["max_rss_kb"] > 0 for s in spans)
    # artifacts do not change with v
    monkeypatch.setattr(port_tracer, "enabled", False)
    monkeypatch.chdir(tmp_path / "plain")
    pipeline.run_scaffold(_cfg(), gap_fill=True, device="cpu")
    os.remove(tmp_path / "traced" / f"{KWZ}.trace.json")
    assert_same_tree(tmp_path / "traced", tmp_path / "plain",
                     [f"{KWZ}.ntLink.scaffolds.gap_fill.fa"])


def test_disabled_tracer_records_nothing(tmp_path, monkeypatch):
    t = tracing.Tracer(enabled=False, torch_profile_dir=str(tmp_path / "p"))
    with t.stage("pair/map-reads"):
        pass
    assert t.spans == [] and not os.path.exists(tmp_path / "p")
    t.write_json(str(tmp_path / "none.json"))
    assert not os.path.exists(tmp_path / "none.json")


def test_profile_writes_a_trace_per_stage(tmp_path, monkeypatch, tracers):
    """CPU-only capture: one Chrome trace per stage; the map-reads trace
    holds the steps' ranges."""
    port_tracer, _ = tracers
    monkeypatch.setenv("NTLINK_TORCH_PROFILE", str(tmp_path / "prof"))
    assert tracing.Tracer().torch_profile_dir == str(tmp_path / "prof")
    monkeypatch.setattr(port_tracer, "torch_profile_dir",
                        str(tmp_path / "prof"))
    write_dataset(tmp_path / "run", seed=92, n_reads=40)
    monkeypatch.chdir(tmp_path / "run")
    pipeline.pair_stage(_cfg(v=1), device="cpu")
    stages = ["pair/contig-sketch", "pair/map-reads", "pair/graph-build"]
    assert [s.name for s in port_tracer.spans if s.parent is None] == stages
    for stage in stages:
        path = tmp_path / "prof" / stage / "trace.json"
        assert os.path.getsize(path) > 0, stage
    with open(tmp_path / "prof" / "pair/map-reads" / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    wanted = set(mapping_step.STAGES) - {"mapping_step/n-windows"}
    assert wanted <= names, wanted - names
    assert "chain/accept" in names and set(chain.STAGES) >= {"chain/accept"}
    with open(tmp_path / "prof" / "pair/contig-sketch" / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "mapping_step/sketch" in names


def test_unwritable_profile_directory_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    t = tracing.Tracer(enabled=True, torch_profile_dir=str(blocker))
    with pytest.raises(OSError):
        with t.stage("pair/map-reads"):
            pass
    assert t.spans == []


def test_enable_sets_the_profile_directory(monkeypatch):
    monkeypatch.setattr(tracing.GLOBAL, "enabled", False)
    monkeypatch.setattr(tracing.GLOBAL, "torch_profile_dir", None)
    assert tracing.enable("somewhere") is tracing.GLOBAL
    assert tracing.GLOBAL.enabled
    assert tracing.GLOBAL.torch_profile_dir == "somewhere"


def test_stage_device_times_attributes_by_stream_and_span(tmp_path):
    """A made-up Chrome trace: device work counts for the range that spans
    it on its own stream, and for none otherwise; the device's time counts
    work on two streams at once once (k1 on streams 7 and 8)."""
    def ev(cat, tid, ts, dur, name):
        return {"ph": "X", "cat": cat, "pid": 0, "tid": tid, "ts": ts,
                "dur": dur, "name": name}

    events = [
        ev("gpu_user_annotation", 7, 10, 100, "mapping_step/sketch"),
        ev("gpu_user_annotation", 7, 200, 50, "mapping_step/join"),
        ev("kernel", 7, 20, 30, "k1"), ev("kernel", 7, 210, 5, "k2"),
        ev("gpu_memcpy", 7, 150, 5, "copy"),   # between the ranges
        ev("kernel", 8, 20, 30, "k1"),         # another stream
        ev("cpu_op", 7, 20, 30, "aten::add"),
        {"ph": "i", "cat": "kernel", "pid": 0, "tid": 7, "ts": 20},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert tracing.stage_device_times(str(path)) == {
        "stages": {"mapping_step/sketch": {"us": 30.0, "events": 1},
                   "mapping_step/join": {"us": 5.0, "events": 1}},
        "unattributed_us": 35.0, "total_us": 40.0,
        "kernels": {"k1": 60.0, "k2": 5.0},
    }


def test_stage_device_times_takes_the_innermost_range(tmp_path):
    """Nested ranges ("chain/accept" around its phases): device work counts
    for the innermost range that spans it, the enclosing range keeps what
    lies between and after its phases, and work past every range counts
    for none."""
    def ev(cat, ts, dur, name):
        return {"ph": "X", "cat": cat, "pid": 0, "tid": 3, "ts": ts,
                "dur": dur, "name": name}

    events = [
        ev("gpu_user_annotation", 100, 300, "chain/accept"),
        ev("gpu_user_annotation", 100, 50, "chain/z-filter"),
        ev("gpu_user_annotation", 160, 100, "chain/noisy-span"),
        ev("gpu_user_annotation", 170, 20, "inner"),
        ev("kernel", 100, 10, "z"),      # same start as its two ranges
        ev("kernel", 175, 10, "i"),      # three ranges deep
        ev("kernel", 200, 10, "n"),      # after "inner", inside noisy-span
        ev("kernel", 300, 10, "keep"),   # after the phases
        ev("kernel", 500, 10, "late"),   # after every range
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = tracing.stage_device_times(str(path))
    assert got["stages"] == {
        "chain/z-filter": {"us": 10.0, "events": 1},
        "inner": {"us": 10.0, "events": 1},
        "chain/noisy-span": {"us": 10.0, "events": 1},
        "chain/accept": {"us": 10.0, "events": 1},
    }
    assert got["unattributed_us"] == 10.0 and got["total_us"] == 50.0


def test_stage_device_times_counts_overlapping_work_once(tmp_path):
    """Two kernels that overlap on two streams of one device: the device's
    time is their union, as the benchmark's busy time; each range and each
    kernel name keeps its own sum."""
    def ev(cat, tid, ts, dur, name, pid=0):
        return {"ph": "X", "cat": cat, "pid": pid, "tid": tid, "ts": ts,
                "dur": dur, "name": name}

    events = [
        ev("gpu_user_annotation", 7, 0, 100, "mapping_step/sketch"),
        ev("kernel", 7, 10, 40, "a"),      # 10..50, in the range
        ev("kernel", 9, 30, 40, "b"),      # 30..70, overlaps a, no range
        ev("kernel", 9, 60, 20, "b"),      # 60..80, overlaps the last b
        ev("kernel", 7, 30, 40, "a", pid=1),  # another device: its own
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = tracing.stage_device_times(str(path))
    assert got["total_us"] == 70.0 + 40.0       # 10..80 on 0, 30..70 on 1
    assert got["unattributed_us"] == 50.0 + 40.0   # 30..80, and device 1
    assert got["stages"] == {"mapping_step/sketch": {"us": 40.0,
                                                     "events": 1}}
    assert got["kernels"] == {"a": 80.0, "b": 60.0}
