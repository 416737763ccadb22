"""Bounded human-scale run of the PyTorch port: a full contig index resident
on one card, and a bounded slice of reads mapped against it.

    python3 scripts/stress_3g_bounded_torch.py <dir> [n_reads] [--device cpu]

The counterpart of ``scripts/stress_3g_bounded.py``. `<dir>` holds
target.fa and reads.fa (``scripts/stress_scale_torch.py <dir> 750 4000000
<n> `` with NTLINK_STRESS_GEN_ONLY=1 writes the human preset's); without
target.fa.k32.w100.tsv there the target is sketched first, through the
`pair` stage's contig path at the default knobs (backend=auto t=4: the card
and four C threads over one stream; `scale.sketch_target`). It reports,
each on its own line: the contig sketch (the card's and the host's
contigs, the card's launches and batches, the sampled peak host RSS),
the TSV parse (seconds, minimizers, contigs, host RSS), the bucket table's
build (seconds, buckets, `max_probes`, the load regime, bytes), the upload
(seconds, device memory after it), and the slice of `n_reads`
(default 20,000) mapped with on-device chaining (reads/s, Mbase/s, peak
device MiB, peak host RSS). Two checks, and the run fails unless both hold:
the table read back from the card equals the host's byte for byte, and the
first 2,000 reads' raw payloads equal those of the native C host path
(`HostMapper`), read by read. The readings end the output as one JSON
line. Runs on the card; without one it exits 1 unless `--device cpu` is
given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ntlink_tpu_torch import device as device_mod  # noqa: E402
from ntlink_tpu_torch import kernel_bench, scale  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir")
    ap.add_argument("n_reads", nargs="?", type=int,
                    default=scale.BOUNDED_READS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu must be asked for")
    ap.add_argument("--check-reads", type=int, default=scale.CHECK_READS)
    args = ap.parse_args(argv)
    try:
        dev = device_mod.resolve(args.device)
    except RuntimeError as exc:
        print(f"stress_3g_bounded_torch: {exc} (give --device cpu to run "
              f"on the host)", file=sys.stderr)
        return 1
    smi = kernel_bench.nvidia_smi() if dev.type == "cuda" else None
    if smi:
        print(f"nvidia-smi: {smi}", flush=True)
    out = scale.bounded_run(args.dir, args.n_reads, device=dev,
                            check_reads=args.check_reads,
                            log=lambda *a: print(*a, flush=True))
    out["nvidia_smi"] = smi
    print("OK", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
