"""The hybrid split of the PyTorch port by its scheduler's depth.

    python3 scripts/probe_hybrid_torch.py [label=frac:threads[:depth_s] ...]
        [--device cpu] [--reads N] [--contigs N]

The counterpart of ``scripts/probe_hybrid.py``: the bench entry point's
workload (`ntlink_tpu_torch.bench.build_workload`) through
`pipeline.map_reads` with a `HybridMapper` over one warmed `TorchMapper`
(chaining on the device, O(runs) payload) and a `HostMapper` of `threads`
workers, best of two runs per spec. `frac` < 0 is the adaptive split,
else the host's pinned share; `depth_s` sets the scheduler's `DEPTH_S`
(seconds of queued work per path before a path counts as full; default
`HybridMapper.DEPTH_S`). Prints reads/s, the card's share of the reads
and the tally's pair count for each spec, with the card's name and power
limit. The default specs: adaptive at `DEPTH_S` 1.0 (the default), 0.25
and 0.05, and the host pinned at half. Runs on the card; without one it
exits 1 unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ntlink_tpu_torch import bench, kernel_bench, pipeline  # noqa: E402
from ntlink_tpu_torch import device as device_mod  # noqa: E402
from ntlink_tpu_torch.config import ScaffoldConfig  # noqa: E402
from ntlink_tpu_torch.device_map import TorchMapper  # noqa: E402
from ntlink_tpu_torch.host_map import HostMapper  # noqa: E402
from ntlink_tpu_torch.hybrid_map import HybridMapper  # noqa: E402

DEFAULT_SPECS = ("adaptive=-1:4:1.0", "depth0.25=-1:4:0.25",
                 "depth0.05=-1:4:0.05", "pin0.5=0.5:4")
RUNS = 2


def parse_spec(spec: str):
    """(label, frac, threads, depth_s or None) of
    `label=frac:threads[:depth_s]`."""
    label, rest = spec.split("=")
    parts = rest.split(":")
    depth = float(parts[2]) if len(parts) > 2 else None
    return label, float(parts[0]), int(parts[1]), depth


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("specs", nargs="*", default=list(DEFAULT_SPECS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu must be asked for")
    ap.add_argument("--reads", type=int, default=bench.N_READS)
    ap.add_argument("--contigs", type=int, default=bench.N_CONTIGS)
    args = ap.parse_args(argv)
    specs = [parse_spec(s) for s in args.specs]
    try:
        dev = device_mod.resolve(args.device)
    except RuntimeError as exc:
        print(f"probe_hybrid_torch: {exc} (give --device cpu to run on the "
              f"host)", file=sys.stderr)
        return 1
    label0 = kernel_bench.nvidia_smi() if dev.type == "cuda" else str(dev)
    _, reads, contig_lengths, index = bench.build_workload(
        n_contigs=args.contigs, n_reads=args.reads)
    clen = np.array([contig_lengths[n] for n in index.contig_names],
                    np.int32)
    bb = bench.BATCH_BASES
    dm = TorchMapper(index, bench.K, bench.W, batch_bases=bb, device=dev,
                     prechain=(clen, bench.Z), runs_only=True)
    with tempfile.TemporaryDirectory(prefix="ntlink_probe_") as tmp:
        reads_fa = os.path.join(tmp, "reads.fa")
        warm_fa = os.path.join(tmp, "warm.fa")
        bench.write_reads(reads_fa, reads)
        bench.write_reads(warm_fa, reads[:bench.WARM_READS])
        pipeline.map_reads(
            ScaffoldConfig(k=bench.K, w=bench.W, z=bench.Z, reads=[warm_fa],
                           batch_bases=bb),
            index, contig_lengths, None, None, dm)
        cfg = ScaffoldConfig(k=bench.K, w=bench.W, z=bench.Z,
                             reads=[reads_fa], batch_bases=bb,
                             backend="hybrid", t=4)
        for label, frac, threads, depth in specs:
            hm = HybridMapper(
                dm, HostMapper(index, bench.K, bench.W, threads=threads,
                               prechain=(clen, bench.Z), runs_only=True),
                frac)
            if depth is not None:
                hm.DEPTH_S = depth
            best = None
            for _ in range(RUNS):
                t0 = time.perf_counter()
                tally = pipeline.map_reads(cfg, index, contig_lengths, None,
                                           None, hm)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            share = hm.device_reads / max(1, hm.device_reads + hm.host_reads)
            print(f"{label0}: {label} (frac {frac}, {threads} host threads, "
                  f"DEPTH_S {hm.DEPTH_S}): best {best:.2f} s -> "
                  f"{len(reads) / best:.1f} reads/s (device share "
                  f"{share:.2f}) pairs={len(tally.pairs)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
