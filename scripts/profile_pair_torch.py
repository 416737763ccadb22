"""Where the device time of the PyTorch port's `pair` stage goes, on one card.

    python3 scripts/profile_pair_torch.py

Writes `chip_smoke.py`'s synthetic dataset (C. elegans scale) to a
temporary directory and runs the port's `pair` through its CLI twice, each
in a fresh directory: once to warm up (kernel build, allocator), then once
under `torch.profiler`. Prints each run's stage and mapping-stream wall
seconds, the profiled run's device self time (kernels and copies, summed as
the profiler's own table total) with its share of that run's mapping stream,
and the profiler's table sorted by device time. Exits 1 without a CUDA
device.
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


def run_pair(root: str, name: str) -> float:
    """The port's `pair` in a fresh directory `root/name`; wall seconds."""
    d = os.path.join(root, name)
    os.makedirs(d)
    for f in ("target.fa", "reads.fa"):
        os.symlink(os.path.join(root, "data", f), os.path.join(d, f))
    t0 = time.perf_counter()
    rc = chip_smoke.run_in(d, lambda: cli.main(chip_smoke.PAIR_ARGV))
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
    with tempfile.TemporaryDirectory(prefix="ntlink_profile_") as root:
        os.makedirs(os.path.join(root, "data"))
        chip_smoke.write_dataset(os.path.join(root, "data"))
        walls = {}
        for name in ("warm-up", "profiled"):
            if name == "profiled":
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    stage_s = run_pair(root, name)
            else:
                stage_s = run_pair(root, name)
            stream_s = pipeline.last_mapper.stream_seconds
            walls[name] = (stage_s, stream_s)
            print(f"profile: {name} run: pair stage {stage_s:.3f} s, "
                  f"mapping stream {stream_s:.3f} s", flush=True)
    events = prof.key_averages()
    device_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    )
    stage_s, stream_s = walls["profiled"]
    print(f"profile: {smi}: profiled run's device self time "
          f"{device_us / 1e3:.3f} ms = {device_us / 1e6 / stream_s:.2%} of "
          f"its mapping stream ({stream_s:.3f} s), "
          f"{device_us / 1e6 / stage_s:.2%} of its pair stage "
          f"({stage_s:.3f} s)")
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
