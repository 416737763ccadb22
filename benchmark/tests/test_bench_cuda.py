"""On the card (``python3 -m pytest benchmark/tests -m cuda``): tiny cells
through the CUDA path, correct, with the step graphs replaying in the
window and the traced window reading the device."""
import pytest

from benchmark import harness
from benchmark.tests.tiny import run_tiny


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stream", "index", "job"])
def test_cell_on_the_card(kind, cuda_device):
    run, out = run_tiny(kind, seconds=2.0, device=None)
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_traced_stream_replays_graphs(cuda_device):
    spec = harness.benchmark_spec()
    per_layer = [m for m in spec["per_layer"]
                 if "rice_ont_stream" in m["workloads"]]
    run, out = run_tiny("stream", seconds=2.0, trace=True,
                        per_layer=per_layer, device=None)
    assert out["correct"], out["compared"]
    before, after = run.counters["graphs_before"], run.counters["graphs_after"]
    assert after[0] == before[0]          # no capture in the window
    assert after[1] > before[1]           # replays in the window
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["sketch_roofline.stream"]["value"] <= 100
