"""Cells of the benchmark's own configurations and mixes cut to a size the
CPU runs in seconds, for the tests."""
import copy
import json
import os
import shutil
import tempfile

from benchmark import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: cell -> (configuration, mix)
CELLS = {
    "stream": ("rice_nipponbare_draft", "ont_r10"),
    "ul": ("rice_nipponbare_draft", "ont_ultralong"),
    "index": ("rice_nipponbare_draft", "index_rounds"),
    "job": ("ecoli_k12_draft", "isolate_jobs"),
}


#: the job cell's end-to-end metric: the cell and its metrics are out of
#: ``BENCHMARK.json`` until its spread allows a bound, and its files stay
#: under test
JOB_S = {"name": "job_s", "unit": "s", "better": "lower",
         "source": "host_clock"}


def load(kind: str, file: str) -> dict:
    with open(os.path.join(HERE, kind, f"{file}.json")) as fh:
        return json.load(fh)


def tiny_cell(kind: str, per_layer=()) -> harness.Cell:
    cfg_name, mix_name = CELLS[kind]
    cfg = copy.deepcopy(load("configs", cfg_name))
    mix = copy.deepcopy(load("mixes", mix_name))
    # the control's key width scaled to the tiny index, so that its keys
    # collide about as often as 32-bit keys do in a 7 M-entry index
    cfg["control_key_bits"] = 22
    if kind == "job":
        cfg["genome"]["length"] = 300_000
        cfg["draft"]["n50"] = 30_000
        mix["coverage"] = 6
    else:
        cfg["genome"]["length"] = 600_000
        cfg["genome"]["repeats"][0]["families"] = 20
        cfg["draft"]["n50"] = 40_000
    for key in ("reads", "probe_reads"):
        if key in mix:
            mix[key].update(median=4000, min=1000, max=40000)
    mix.update(pass_bases=600_000, probe_bases=300_000, sample_reads=20)
    e2e = harness.benchmark_spec()["end_to_end"]
    if kind == "job":
        e2e = e2e + [JOB_S]
    return harness.Cell(f"tiny_{kind}", cfg, mix, e2e, list(per_layer))


def run_tiny(kind: str, seed: int = 987654321012, seconds: float = 0.5,
             trace: bool = False, control: bool = False, per_layer=(),
             device: str = "cpu"):
    """execute() of a tiny cell on `device` (the CPU, or None: the card);
    returns (run, result)."""
    cell = tiny_cell(kind, per_layer)
    wd = tempfile.mkdtemp(prefix="bench-test-")
    try:
        run = harness.Run(cell, seed, seconds, trace, wd, device=device,
                          control=control)
        return run, harness.execute(run)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
