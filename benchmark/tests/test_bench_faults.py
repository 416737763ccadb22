"""Whole runs of tiny cells on the CPU (the harness's look for a card
skipped): sound runs are correct, and `correct` comes out false with the
timed path broken underneath, once for each fault a cell can have, and for
the control (the reference with its index keyed below the configuration's
guarantee in the program's place). One chip only: no exchange between
chips to leave out."""
import numpy as np
import pytest

from ntlink_tpu_torch import device_map, pipeline

from benchmark import harness
from benchmark.tests.tiny import run_tiny


def _faulty_stream(fault):
    real = device_map.TorchMapper.map_stream_raw

    def map_stream_raw(self, named_seqs):
        for i, (name, length, raw) in enumerate(real(self, named_seqs)):
            if fault == "unchanged":        # the step hands back nothing
                raw = None
            elif fault == "half" and i % 2:   # half of the batch left out
                raw = None
            elif fault == "altered" and raw is not None and raw[0]:
                raw = list(raw)             # an answer altered: one anchor
                raw[3] = raw[3].copy()
                raw[3][0] += 1
                raw = tuple(raw)
            yield name, length, raw
    return map_stream_raw


@pytest.mark.parametrize("kind", ["stream", "ul", "index", "job"])
def test_sound_run_is_correct(kind):
    run, out = run_tiny(kind)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    e2e = {"stream": "read_Mbase_per_s", "ul": "read_Mbase_per_s",
           "index": "index_s", "job": "job_s"}[kind]
    assert out["metrics"][e2e]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("kind", ["stream", "index", "job"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_makes_the_run_incorrect(kind, fault, monkeypatch):
    monkeypatch.setattr(device_map.TorchMapper, "map_stream_raw",
                        _faulty_stream(fault))
    run, out = run_tiny(kind)
    assert not out["correct"], (kind, fault, out["compared"])


def test_altered_contig_sketch_makes_the_run_incorrect(monkeypatch):
    real = pipeline.ensure_contig_sketch_tsv

    def ensure(cfg, k, w, device=None):
        out = real(cfg, k, w, device=device)
        with open(out, "rb") as fh:   # one strand flipped in every line
            lines = [line.replace(b":+", b":-", 1)
                     for line in fh.read().split(b"\n")]
        with open(out, "wb") as fh:
            fh.write(b"\n".join(lines))
        return out

    monkeypatch.setattr(pipeline, "ensure_contig_sketch_tsv", ensure)
    for kind in ("stream", "index"):
        run, out = run_tiny(kind)
        assert not out["correct"]
        assert out["parts"]["tsv_contigs"] > 0


@pytest.mark.parametrize("kind", ["stream", "ul", "index", "job"])
def test_control_is_incorrect(kind):
    run, out = run_tiny(kind, control=True)
    assert not out["correct"], out["parts"]
    assert out["compared"]["outputs_differing"]["value"] > 0
    assert out["attempted"] == 0 and out["metrics"] == {}


def test_traced_run_reports_per_layer_metrics():
    spec = harness.benchmark_spec()
    per_layer = [m for m in spec["per_layer"]
                 if "rice_ont_stream" in m["workloads"]]
    run, out = run_tiny("stream", trace=True, per_layer=per_layer)
    assert out["correct"]
    # on the CPU the device metrics have nothing to read
    assert set(out["metrics"]) == {"reader_pull_share.stream",
                                   "producer_unkeyed_share.stream"}
    for m in out["metrics"].values():
        assert 0 < m["value"] < 100
    assert out["device"]["window_s"] > 0
    assert np.isfinite(out["device"]["busy_s"])
