"""The interval arithmetic behind the device's busy and idle time, and the
sketch kernel's roofline counts."""
import pytest

from benchmark import harness, trace
from benchmark.tests.tiny import tiny_cell


def test_merge_counts_overlaps_once():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.5, 2.7), (3.0, 3.5)]
    assert trace.merge(iv) == [(0.0, 1.5), (2.0, 3.5)]
    assert sum(b - a for a, b in trace.merge(iv)) == pytest.approx(3.0)
    assert trace.gaps(iv, -1.0, 4.0) == [(-1.0, 0.0), (1.5, 2.0),
                                         (3.5, 4.0)]


def test_trace_reads_chrome_events():
    events = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 120, "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 300,
         "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "bench::window",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "bench::pass 0",
         "ts": 0, "dur": 500},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "bench::pass 0",
         "ts": 0, "dur": 500},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 5, "dur": 1},
    ]}
    t = trace.read_chrome_trace(events)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(80e-6)
    assert t.busy_s("k1", kernels_only=True) == pytest.approx(50e-6)
    assert t.busy_s(kernels_only=True) == pytest.approx(70e-6)
    assert [n for n, _ in t.top_ops()] == ["k1", "k2", "Memcpy HtoD"]
    gaps = t.idle_gaps()
    assert gaps[0][0] == "window" and gaps[0][1] == pytest.approx(690e-6)
    assert ("pass 0", pytest.approx(130e-6)) in [tuple(g) for g in gaps]


class _Run:
    def __init__(self, trace_, bases):
        self.window_trace = trace_
        self.counters = {"read_bases": bases}
        self.config = tiny_cell("stream").config


def _roofline(kernel_s, bases):
    t = trace.Trace(0.0, 1.0, [("sketch_rows_kernel(...)", 0.0, kernel_s,
                                "kernel")])
    return harness.reader_for("sketch_roofline.stream")(_Run(t, bases))


def test_roofline_counts_and_share():
    mod = harness.load_module(
        harness.ROOT + "/benchmark/metrics/sketch_roofline.stream.py", "rf")
    rf = harness.load_json(harness.ROOT + "/benchmark/metrics/roofline.json")
    bases, w = 1e9, 100
    ops = bases * rf["sketch"]["int32_ops_per_base"] / rf["int32_ops_per_s"]
    nbytes = bases * (0.25 + 13 * 2 / 101) / rf["hbm_bytes_per_s"]
    least = mod.least_seconds(bases, w, rf)
    assert least == pytest.approx(max(ops, nbytes))
    assert ops > nbytes   # the integer operations bind
    assert _roofline(least, bases) == pytest.approx(100.0)
    assert _roofline(2 * least, bases) == pytest.approx(50.0)
    assert _roofline(0.0, bases) is None
