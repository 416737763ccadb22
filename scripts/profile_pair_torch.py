"""Where the device time of the PyTorch port's `pair` stage goes, on one card.

    python3 scripts/profile_pair_torch.py

Writes `chip_smoke.py`'s synthetic dataset (C. elegans scale) to a
temporary directory and runs the port's `pair` through its CLI three times,
each in a fresh directory (so each sketches the contigs too, at the
default knobs on the card and four C threads at once): once to warm
up (kernel build, allocator), then the default run (verbose, prechained)
and the lean run (verbose=False, runs-only), each with v=1 and the
tracer's ``torch.profiler`` hook on (`tracing.Tracer.torch_profile_dir`),
which writes one Chrome trace per stage. Prints each run's stage,
contig-sketch and mapping-stream wall seconds, and for the
`pair/contig-sketch` and `pair/map-reads` traces of each profiled run the
device time by `record_function` range (`tracing.stage_device_times`:
unpack, sketch, N windows, select, join, chaining by phase as
``scripts/probe_chain_phases.py`` splits it for the JAX package (z filter,
noisy span, run grouping, run contigs, subsume, and the keep mask under
"chain/accept"), run summary, compaction, and what lies outside every
range, the copies to the host among it), the
device's busy share of the stage's wall time, and the five kernels that
took most. Every run has ``NTLINK_TIMING=1`` set, and the read stream's
host-side split (`TorchMapper.last_timing`: seconds per phase, by the
thread that each is timed on) is printed beside the device split of
`pair/map-reads`, and the contig sketch's split between the card and the
host. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the dataset and the CLI's argv)
from ntlink_tpu_torch import bench, cli, pipeline, tracing  # noqa: E402

STAGES = ("pair/contig-sketch", "pair/map-reads")


def run_pair(root: str, name: str, argv) -> float:
    """The port's `pair` in a fresh directory `root/name`; wall seconds."""
    d = os.path.join(root, name)
    os.makedirs(d)
    for f in ("target.fa", "reads.fa"):
        os.symlink(os.path.join(root, "data", f), os.path.join(d, f))
    t0 = time.perf_counter()
    rc = chip_smoke.run_in(d, lambda: cli.main(argv))
    torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit(f"pair exited {rc}")
    return time.perf_counter() - t0


def print_split(label: str, trace_path: str, wall_s: float) -> dict:
    """Print one trace's device time by range; returns the split."""
    split = tracing.stage_device_times(trace_path)
    total = split["total_us"]
    print(f"{label}: device time {total / 1e3:.3f} ms = "
          f"{total / 1e6 / wall_s:.2%} of the stage's {wall_s:.3f} s wall")
    rows = sorted(split["stages"].items(), key=lambda kv: -kv[1]["us"])
    rows.append(("(outside every range)",
                 {"us": split["unattributed_us"], "events": None}))
    for name, row in rows:
        print(f"{label}:   {name:<26} {row['us'] / 1e3:10.3f} ms "
              f"{row['us'] / max(total, 1e-9):7.2%}"
              + ("" if row["events"] is None
                 else f"  ({row['events']} kernels and copies)"))
    top = sorted(split["kernels"].items(), key=lambda kv: -kv[1])[:5]
    for name, us in top:
        print(f"{label}:   kernel {name[:60]:<60} {us / 1e3:10.3f} ms")
    return split


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_pair_torch: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    runs = (("warm-up", chip_smoke.PAIR_ARGV),
            ("default", chip_smoke.PAIR_ARGV + ["v=1"]),
            ("lean", chip_smoke.LEAN_ARGV + ["v=1"]))
    tracer = tracing.GLOBAL
    os.environ["NTLINK_TIMING"] = "1"
    with tempfile.TemporaryDirectory(prefix="ntlink_profile_") as root:
        os.makedirs(os.path.join(root, "data"))
        chip_smoke.write_dataset(os.path.join(root, "data"))
        for name, argv in runs:
            tracer.spans.clear()
            tracer.torch_profile_dir = (
                None if name == "warm-up" else os.path.join(root, "prof", name)
            )
            stage_s = run_pair(root, name, argv)
            sk = pipeline.last_sketcher
            stream_s = pipeline.last_mapper.stream_seconds
            print(f"profile: {smi}: {name} run: pair stage {stage_s:.3f} s, "
                  f"contig sketch {sk.stream_seconds:.3f} s (card "
                  f"{sk.device_seqs}, host {sk.host_seqs} contigs; "
                  f"{sk.kernel_launches} launches for "
                  f"{sum(sk.batches_by_pad.values())} card batches), "
                  f"mapping stream "
                  f"{stream_s:.3f} s (profiler "
                  f"{'off' if name == 'warm-up' else 'on'})", flush=True)
            if name == "warm-up":
                continue
            walls = {s.name: s.wall_s for s in tracer.spans}
            for stage in STAGES:
                print_split(
                    f"profile: {name} {stage}",
                    os.path.join(tracer.torch_profile_dir, stage,
                                 "trace.json"),
                    walls[stage],
                )
            # the run's mapper is new and maps one stream, so its stream
            # seconds are that stream's wall
            for line in bench.timing_lines(
                    smi, pipeline.last_mapper.last_timing, stream_s):
                print(f"profile: {name} pair/map-reads host side:",
                      line.lstrip("# "))
    return 0


if __name__ == "__main__":
    sys.exit(main())
