"""One run of one cell: find its files by name, set the program up, measure
for the window, check the outputs against the reference, print one line.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, its configuration (``configs/<config>.json``), its
traffic mix (``mixes/<traffic>.json``, whose ``mode`` names the window's
driver, ``drivers/<mode>.py``) and one reader per per-layer metric
(``metrics/<metric>.py``). A driver module has four functions:

- ``setup(run)``: the data from the seed, the program set up as its flow
  sets it up, every shape of this cell warmed; returns its state;
- ``window(run, state)``: the measured work, back to back until
  ``run.seconds`` have passed; sets ``run.e2e`` (the end-to-end metrics),
  ``run.units`` (work started, work that failed) and ``run.counters``
  (what the per-layer readers read);
- ``release(run, state)``: frees the program's device state;
- ``check(run, state)``: the reference's comparison, a list of
  (name, count) of outputs that differ, by kind. The run compares one
  number, their sum `outputs_differing`, with the limit 0: the control
  and every planted fault move it (``README.md``), where some parts
  alone have no reading from the control.

With ``run.control`` set, ``setup`` makes the data alone and ``check``
puts the reference computed below the configuration's guarantee in the
program's place (see ``README.md``).
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that must not be loaded where the result is
#: printed
FORBIDDEN = ("jax", "jaxlib", "flax", "ntlink_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    #: the checkout the cell's files were found in
    root: str = ROOT
    chips: int = 1


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    workdir: str
    #: what the program's flows take as `device`: None (the card, as the
    #: CLI leaves it), a list of cards, or "cpu" (the tests, the control)
    device: object = None
    control: bool = False
    e2e: Dict[str, float] = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    units: Tuple[int, int] = (0, 0)
    #: the traced window (`trace.Trace`), with --trace 1
    window_trace: object = None
    #: the open profiler during a traced window, for the drivers' markers
    profiler: object = None
    #: (kind, count) of the outputs that differ from the reference
    parts: List[tuple] = field(default_factory=list)
    setup_s: float = 0.0

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    def path(self, name: str) -> str:
        return os.path.join(self.workdir, name)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark_spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_cell(name: str, spec: Optional[dict] = None,
              root: str = ROOT) -> Cell:
    """The cell `name` of ``BENCHMARK.json``, with its files."""
    spec = spec or benchmark_spec(root)
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(wl)}")
    w = wl[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(os.path.join(root, cfg["file"]))
    mix = load_json(os.path.join(root, "benchmark", "mixes",
                                 f"{w['traffic']}.json"))
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reported]
    return Cell(name, config, mix, e2e, per_layer, root, int(w["chips"]))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_for(mix: dict, root: str = ROOT):
    mode = mix["mode"]
    return load_module(os.path.join(root, "benchmark", "drivers",
                                    f"{mode}.py"), f"benchmark_driver_{mode}")


def _module_name(metric: str) -> str:
    return "benchmark_metric_" + "".join(
        c if c.isalnum() else "_" for c in metric)


def reader_for(metric: str, root: str = ROOT):
    """``metrics/<metric>.py``'s `read`."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    return load_module(path, _module_name(metric)).read


def process_age() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cards(device) -> List[int]:
    """The CUDA device indices a run's `device` names (none for "cpu")."""
    if device is None:
        return [0]
    names = device if isinstance(device, (list, tuple)) else [device]
    return [int(str(d).split(":")[1]) for d in names if d != "cpu"]


def device_info(device) -> dict:
    import torch

    ids = cards(device)
    if not ids:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(ids[0]),
            "count": len(ids),
            "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(i))
                                     for i in ids)}


def execute(run: Run) -> dict:
    """Set up, measure, check; returns the result object."""
    from . import trace as trace_mod

    drv = driver_for(run.mix, run.cell.root)
    state = drv.setup(run)
    # the data written in set-up goes to disk now, not during the window
    os.sync()
    run.setup_s = process_age()
    if run.control:
        run.parts = drv.check(run, state)
        return result(run, {})
    if run.trace:
        os.environ["NTLINK_TIMING"] = "1"
        with trace_mod.Profiler(run.workdir) as prof:
            run.profiler = prof
            with prof.mark("window"):
                drv.window(run, state)
        run.profiler = None
        run.window_trace = prof.trace
    else:
        drv.window(run, state)
    # each unit's wall seconds, and the process's CPU seconds in it, where
    # the driver keeps them: a unit slow in wall time alone waited
    for key, label in (("unit_seconds", "unit seconds"),
                       ("unit_cpu_seconds", "unit cpu seconds")):
        if run.counters.get(key):
            print(f"# bench {label}: " + " ".join(
                f"{x:.3f}" for x in run.counters[key]), file=sys.stderr)
    info = device_info(run.device)
    drv.release(run, state)
    run.parts = drv.check(run, state)
    metrics = {}
    if run.trace:
        for m in run.cell.per_layer:
            value = reader_for(m["name"], run.cell.root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        run.e2e["setup_s"] = run.setup_s
        for m in run.cell.end_to_end:
            if m["name"] in run.e2e:
                metrics[m["name"]] = {"value": run.e2e[m["name"]],
                                      "unit": m["unit"]}
    return result(run, metrics, info)


#: outputs that may differ from the reference: an exact comparison
LIMIT = 0


def compared(run: Run) -> int:
    return sum(n for _, n in run.parts)


def result(run: Run, metrics: dict, info: Optional[dict] = None) -> dict:
    correct = bool(run.parts) and compared(run) <= LIMIT
    out = {
        "correct": correct,
        "attempted": run.units[0],
        "failed": run.units[1],
        "metrics": metrics,
        "device": info or device_info(run.device),
    }
    t = run.window_trace
    if t is not None:
        out["device"]["busy_s"] = t.busy_s()
        out["device"]["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": t.top_ops(10),
                            "idle_gaps": t.idle_gaps(10)}
    out["parts"] = dict(run.parts)
    out["compared"] = {"outputs_differing": {"value": compared(run),
                                             "limit": LIMIT}}
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="the reference below the configuration's "
                         "guarantee in the program's place (no window)")
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    import torch

    if not args.control and not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not args.control and torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA device(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    workdir = tempfile.mkdtemp(prefix="ntlink-bench-", dir=base)
    try:
        device = ("cpu" if args.control else None if cell.chips == 1
                  else [f"cuda:{i}" for i in range(cell.chips)])
        run = Run(cell, args.seed, args.seconds, bool(args.trace), workdir,
                  device=device, control=bool(args.control))
        out = execute(run)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"modules that must not load here were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, n in run.parts:
        print(f"# differing {name}: {n}", file=sys.stderr)
    print(f"compared outputs_differing: {compared(run)} (limit {LIMIT})",
          file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
