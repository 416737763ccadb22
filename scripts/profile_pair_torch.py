"""Where the device time of the PyTorch port's `pair` stage goes, on one card.

    python3 scripts/profile_pair_torch.py

Writes `chip_smoke.py`'s synthetic dataset (C. elegans scale) to a
temporary directory and runs the port's `pair` through its CLI three times,
each in a fresh directory (so each sketches the contigs too): once to warm
up (kernel build, allocator), then the default run (verbose, prechained)
and the lean run (verbose=False, runs-only), each under `torch.profiler`.
Prints each run's stage, contig-sketch and mapping-stream wall seconds, each
profiled run's device self time (kernels and copies, summed as the
profiler's own table total) with its share of the stage, and the
profiler's table sorted by device time. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the dataset and the CLI's argv)
from ntlink_tpu_torch import cli, pipeline  # noqa: E402


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
            ("default", chip_smoke.PAIR_ARGV),
            ("lean", chip_smoke.LEAN_ARGV))
    with tempfile.TemporaryDirectory(prefix="ntlink_profile_") as root:
        os.makedirs(os.path.join(root, "data"))
        chip_smoke.write_dataset(os.path.join(root, "data"))
        for name, argv in runs:
            prof = None
            if name == "warm-up":
                stage_s = run_pair(root, name, argv)
            else:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    stage_s = run_pair(root, name, argv)
            sketch_s = pipeline.last_sketcher.stream_seconds
            stream_s = pipeline.last_mapper.stream_seconds
            print(f"profile: {name} run: pair stage {stage_s:.3f} s, "
                  f"contig sketch {sketch_s:.3f} s, mapping stream "
                  f"{stream_s:.3f} s", flush=True)
            if prof is None:
                continue
            events = prof.key_averages()
            device_us = sum(
                e.self_device_time_total for e in events
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation
            )
            print(f"profile: {smi}: {name} run's device self time "
                  f"{device_us / 1e3:.3f} ms = "
                  f"{device_us / 1e6 / stage_s:.2%} of its pair stage "
                  f"({stage_s:.3f} s)")
            print(events.table(sort_by="self_device_time_total",
                               row_limit=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
