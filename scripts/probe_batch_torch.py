"""Mapping throughput of the PyTorch port by device batch size.

    python3 scripts/probe_batch_torch.py [MB ...] [--device cpu]
        [--reads N] [--contigs N]

The counterpart of ``scripts/probe_batch.py``: the bench entry point's
workload (`ntlink_tpu_torch.bench.build_workload`), one `TorchMapper` per
`batch_bases` (default 16, 32 and 64 Mbases; chaining on the device,
O(runs) payload, the bench's device leg), a 64-read warm-up, then the best
of three `pipeline.map_reads` runs over the reads file. Prints reads/s,
the tally's pair count and the mapper's `wire_stats` for each size, with
the card's name and power limit. Runs on the card; without one it exits 1
unless `--device cpu` is given (`--reads` and `--contigs` shrink the
workload, for the tests).
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

RUNS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mb", nargs="*", type=int, default=[16, 32, 64],
                    help="batch sizes in Mbases")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu must be asked for")
    ap.add_argument("--reads", type=int, default=bench.N_READS)
    ap.add_argument("--contigs", type=int, default=bench.N_CONTIGS)
    args = ap.parse_args(argv)
    try:
        dev = device_mod.resolve(args.device)
    except RuntimeError as exc:
        print(f"probe_batch_torch: {exc} (give --device cpu to run on the "
              f"host)", file=sys.stderr)
        return 1
    label = kernel_bench.nvidia_smi() if dev.type == "cuda" else str(dev)
    _, reads, contig_lengths, index = bench.build_workload(
        n_contigs=args.contigs, n_reads=args.reads)
    clen = np.array([contig_lengths[n] for n in index.contig_names],
                    np.int32)
    with tempfile.TemporaryDirectory(prefix="ntlink_probe_") as tmp:
        reads_fa = os.path.join(tmp, "reads.fa")
        warm_fa = os.path.join(tmp, "warm.fa")
        bench.write_reads(reads_fa, reads)
        bench.write_reads(warm_fa, reads[:bench.WARM_READS])
        for mb in args.mb:
            bb = mb * 1_000_000
            mapper = TorchMapper(index, bench.K, bench.W, batch_bases=bb,
                                 device=dev, prechain=(clen, bench.Z),
                                 runs_only=True)
            cfg = ScaffoldConfig(k=bench.K, w=bench.W, z=bench.Z,
                                 reads=[reads_fa], batch_bases=bb)
            pipeline.map_reads(
                ScaffoldConfig(k=bench.K, w=bench.W, z=bench.Z,
                               reads=[warm_fa], batch_bases=bb),
                index, contig_lengths, None, None, mapper)
            mapper.wire_stats.update(h2d=0, d2h=0, h2d_s=0.0, d2h_s=0.0)
            best = None
            for _ in range(RUNS):
                t0 = time.perf_counter()
                tally = pipeline.map_reads(cfg, index, contig_lengths, None,
                                           None, mapper)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            print(f"{label}: batch_bases={mb}M: best {best:.2f} s -> "
                  f"{len(reads) / best:.1f} reads/s, pairs={len(tally.pairs)}"
                  f", batches by (pad, has N) {mapper.batches_by_pad}, "
                  f"wire={mapper.wire_stats}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
