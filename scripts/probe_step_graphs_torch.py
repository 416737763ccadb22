"""The read stream's host dispatch, CUDA API calls and device time per batch,
with the step graphs of ``ntlink_tpu_torch/step_graph.py`` or without.

    python3 scripts/probe_step_graphs_torch.py [--runs N] [--reads N]
        [--contigs N] [--eager] [--device cpu]
        [--index-sharding hash --idx-shards N]

Maps the bench entry point's workload (`ntlink_tpu_torch.bench`'s
`build_workload`: 16 contigs of 250 kb, 30,000 reads of 15 kb, from
``default_rng(42)``) with one `TorchMapper` built as the bench's device
leg builds it (chaining on the device, O(runs) payload, batches of
`bench.BATCH_BASES` bases; with `--index-sharding hash` the table is
hash-sharded over a 1 x `--idx-shards` grid that names the device
`--idx-shards` times, chaining on the host, as ``TorchMapper`` runs a hash
grid), after the bench's 64-read warm-up: `--runs`
times with NTLINK_TIMING=1, then once more under ``torch.profiler`` (every
thread). Prints one JSON line: the reads/s of each run, their best and
median; the feeder's `dispatch` per batch (ms, and its share of the last
run's stream wall), that run's stream seconds and `wire_stats` (bytes each
way, the feeder's upload seconds and the drainer's blocked seconds); per
batch of the profiled run the device time of its kernels and copies
(summed, of the ten that take most, and the time in which one or more
ran: kernels of streams that overlap count once there), and the CUDA API
calls that put work on the card (kernel and graph launches, copies,
memsets, by name); the device's busy share (summed time) of that run's
wall and of the last timed run's stream wall; the step graphs' captures, replays,
capture seconds and first batches run eagerly; the peak device MiB; the
card's name and power limit.

`--eager` sets NTLINK_TORCH_PROFILE while the mapper is made, which runs
its steps eagerly (the profiler's switch, ``tracing.profiling``; a hash
grid made later keeps the mapper's choice). Another
checkout's package runs with ``PYTHONPATH=<checkout>`` (this script adds
its own checkout after PYTHONPATH); a package without step graphs runs
eagerly and reports none. Runs on the card; without one it exits 1 unless
`--device cpu` is given (the CPU reports no device numbers).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import ntlink_tpu_torch  # noqa: E402
from ntlink_tpu_torch import bench, kernel_bench, pipeline  # noqa: E402
from ntlink_tpu_torch import device as device_mod  # noqa: E402
from ntlink_tpu_torch.config import ScaffoldConfig  # noqa: E402
from ntlink_tpu_torch.device_map import TorchMapper  # noqa: E402

#: CUDA API calls that put work on the card
ENQUEUE = ("Launch", "Memcpy", "Memset")


def trace_counts(path: str) -> dict:
    """Device microseconds of the kernels and copies in a Chrome trace of
    ``torch.profiler``: summed, by name, and as the time in which at least
    one ran (kernels of several streams that overlap count once there);
    and its CUDA API calls by name."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device_us, calls, by_name, spans = 0.0, {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device_us += e["dur"]
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
            spans.append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            calls[e["name"]] = calls.get(e["name"], 0) + 1
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"device_us": device_us, "busy_us": busy_us, "calls": calls,
            "by_name": by_name}


def graph_counts(mapper) -> list:
    """The mapper's `graph_counts()` as a list ([captures, replays,
    capture seconds, first batches eager]), or None for a package whose
    mapper has no step graphs or whose steps ran eagerly."""
    counts = getattr(mapper, "graph_counts", lambda: None)()
    return None if counts is None else list(counts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu must be asked for")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--reads", type=int, default=bench.N_READS)
    ap.add_argument("--contigs", type=int, default=bench.N_CONTIGS)
    ap.add_argument("--eager", action="store_true",
                    help="run the steps eagerly (NTLINK_TORCH_PROFILE)")
    ap.add_argument("--index-sharding", default="replicated",
                    choices=("replicated", "hash"))
    ap.add_argument("--idx-shards", type=int, default=2,
                    help="idx ranks of the hash grid, all on the one device")
    args = ap.parse_args(argv)
    try:
        dev = device_mod.resolve(args.device)
    except RuntimeError as exc:
        print(f"probe_step_graphs_torch: {exc} (give --device cpu to run "
              f"on the host)", file=sys.stderr)
        return 1
    on_cuda = dev.type == "cuda"
    os.environ["NTLINK_TIMING"] = "1"
    _, reads, contig_lengths, index = bench.build_workload(
        n_contigs=args.contigs, n_reads=args.reads)
    clen = np.array([contig_lengths[n] for n in index.contig_names],
                    np.int32)
    with tempfile.TemporaryDirectory(prefix="ntlink_graphs_") as root:
        reads_fa = os.path.join(root, "reads.fa")
        warm_fa = os.path.join(root, "warm.fa")
        bench.write_reads(reads_fa, reads)
        bench.write_reads(warm_fa, reads[: bench.WARM_READS])

        def cfg_for(path):
            return ScaffoldConfig(k=bench.K, w=bench.W, z=bench.Z,
                                  reads=[path],
                                  batch_bases=bench.BATCH_BASES)

        if args.eager:
            os.environ["NTLINK_TORCH_PROFILE"] = os.path.join(root, "none")
        layout = (dict(device=dev) if args.index_sharding == "replicated"
                  else dict(devices=[dev] * args.idx_shards,
                            index_sharding="hash",
                            idx_shards=args.idx_shards))
        mapper = TorchMapper(index, bench.K, bench.W,
                             batch_bases=bench.BATCH_BASES,
                             prechain=(clen, bench.Z), runs_only=True,
                             **layout)
        os.environ.pop("NTLINK_TORCH_PROFILE", None)

        def run(cfg):
            pipeline.map_reads(cfg, index, contig_lengths, None, None,
                               mapper)
            if on_cuda:
                torch.cuda.synchronize(dev)

        if on_cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        run(cfg_for(warm_fa))
        rates = []
        for _ in range(args.runs):
            batches0 = sum(mapper.batches_by_pad.values())
            stream0 = mapper.stream_seconds
            wire0 = dict(mapper.wire_stats)
            t0 = time.perf_counter()
            run(cfg_for(reads_fa))
            rates.append(len(reads) / (time.perf_counter() - t0))
        # the last run's timing split and stream wall
        secs, spans = mapper.last_timing["dispatch"]
        out = {
            "package": os.path.dirname(ntlink_tpu_torch.__file__),
            "eager_asked": args.eager,
            "layout": mapper.layout(),
            "reads": len(reads),
            "reads_per_s": rates,
            "best_reads_per_s": max(rates),
            "median_reads_per_s": statistics.median(rates),
            "batches_per_run": sum(mapper.batches_by_pad.values())
            - batches0,
            "dispatch_ms_per_batch": 1e3 * secs / spans,
            "dispatch_share_of_stream": secs / (mapper.stream_seconds
                                                - stream0),
            "stream_seconds": mapper.stream_seconds - stream0,
            "wire_stats": {k: v - wire0[k]
                           for k, v in mapper.wire_stats.items()},
        }
        if on_cuda:
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import ProfilerActivity, profile

            batches0 = sum(mapper.batches_by_pad.values())
            prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                experimental_config=_ExperimentalConfig(
                    profile_all_threads=True))
            t0 = time.perf_counter()
            prof.start()
            run(cfg_for(reads_fa))
            prof.stop()
            wall_s = time.perf_counter() - t0
            pb = sum(mapper.batches_by_pad.values()) - batches0
            path = os.path.join(root, "trace.json")
            prof.export_chrome_trace(path)
            tc = trace_counts(path)
            enqueue = {n: c for n, c in tc["calls"].items()
                       if any(word in n for word in ENQUEUE)}
            out.update({
                "profiled_batches": pb,
                "device_ms_per_batch": tc["device_us"] / 1e3 / pb,
                # the device's busy time per batch: overlapping kernels
                # (the hash grid's cells on streams of their own) once
                "device_busy_ms_per_batch": tc["busy_us"] / 1e3 / pb,
                "device_busy_share": tc["device_us"] / 1e6 / wall_s,
                # the profiler slows the host: the same device time over
                # the last timed run's stream wall
                "device_busy_share_of_timed_stream": (
                    tc["device_us"] / 1e6 / pb * out["batches_per_run"]
                    / out["stream_seconds"]),
                "profiled_wall_s": wall_s,
                "enqueue_calls_per_batch": sum(enqueue.values()) / pb,
                "enqueue_calls_by_name": enqueue,
                # the ten kernels and copies of most device time
                "device_ms_per_batch_by_name": {
                    n[:80]: us / 1e3 / pb for n, us in sorted(
                        tc["by_name"].items(), key=lambda kv: -kv[1])[:10]},
                "api_calls_per_batch": sum(tc["calls"].values()) / pb,
                "peak_device_mib": torch.cuda.max_memory_allocated(dev)
                / 2**20,
                "nvidia_smi": kernel_bench.nvidia_smi(),
            })
        out["step_graphs"] = graph_counts(mapper)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
