"""Scale stress of the PyTorch port: the whole `scaffold gap_fill` flow on a
synthetic assembly whose contigs adjoin in truth, with per-stage tracing
and memory readings.

    python3 scripts/stress_scale_torch.py [workdir] [n_contigs] [contig_len]
                                          [n_reads] [--device cpu]

The counterpart of ``scripts/stress_scale.py``, with its arguments and
presets:

    100 Mb:   scripts/stress_scale_torch.py <dir> 250 400000 10000
    200 Mb:   scripts/stress_scale_torch.py <dir> 500 400000 20000
    human 3G: scripts/stress_scale_torch.py <dir> 750 4000000 2500000
              (3 Gbase target, 30 Gbase of reads = 10x; ~33 GB of FASTA)

The generator is ``ntlink_tpu_torch.scale.write_stress_dataset``, a copy of
that script's (the same files byte for byte): NTLINK_STRESS_GAPPED=1 puts N
runs into the contigs, NTLINK_STRESS_GEN_ONLY=1 stops after writing the
data (no card needed), and a marker file keeps a dataset of other
arguments from being taken for this one. The flow is
`ntlink_tpu_torch.pipeline.run_scaffold(cfg, gap_fill=True)` under
`tracing.enable()`, with backend NTLINK_STRESS_BACKEND (default auto). It
prints each stage's wall seconds, peak device MiB
(`torch.cuda.max_memory_allocated` over the stage) and peak host RSS; the
`pair` stage split into the contig sketch with its TSV, the index parse,
the table's build and upload and the read mapping; the joins made out of
n_contigs - 1; and one JSON line at the end with the same numbers. Runs on
the card; without one it exits 1 unless `--device cpu` is given
(NTLINK_STRESS_BACKEND=numpy then maps on the host).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from ntlink_tpu_torch import device as device_mod  # noqa: E402
from ntlink_tpu_torch import kernel_bench, pipeline, scale, tracing  # noqa: E402
from ntlink_tpu_torch.config import ScaffoldConfig  # noqa: E402
from ntlink_tpu_torch.pathio import read_path_file  # noqa: E402


def stage_walls(tracer, total_s: float) -> dict:
    """Wall seconds by stage, with `pair` split at its own clocks."""
    walls = {s.name: s.wall_s for s in tracer.spans}
    mapper = pipeline.last_mapper
    out = {
        "sketch_tsv": walls.get("pair/contig-sketch", 0.0)
        - pipeline.last_index_seconds,
        "index_parse": pipeline.last_index_seconds,
        "table_build": getattr(mapper, "build_seconds", None),
        "upload": getattr(mapper, "upload_seconds", None),
        "mapping": pipeline.last_map_seconds,
        "graph": walls.get("pair/graph-build"),
        "layout_stitch": walls.get("layout+stitch"),
        "overlap": walls.get("overlap-trim"),
        "merge": walls.get("merge"),
        "gap_fill": walls.get("gap-fill"),
        "total": total_s,
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?",
                    default=os.path.join(tempfile.gettempdir(),
                                         "ntlink_stress"))
    ap.add_argument("n_contigs", nargs="?", type=int, default=250)
    ap.add_argument("contig_len", nargs="?", type=int, default=400_000)
    ap.add_argument("n_reads", nargs="?", type=int, default=10_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu must be asked for")
    args = ap.parse_args(argv)
    gen_only = bool(os.environ.get("NTLINK_STRESS_GEN_ONLY"))
    backend = os.environ.get("NTLINK_STRESS_BACKEND", "auto")
    dev = None
    if not gen_only:
        try:
            dev = device_mod.resolve(args.device)
        except RuntimeError as exc:
            print(f"stress_scale_torch: {exc} (give --device cpu to run on "
                  f"the host)", file=sys.stderr)
            return 1
    workdir = os.path.abspath(args.workdir)
    scale.write_stress_dataset(
        workdir, args.n_contigs, args.contig_len, args.n_reads,
        gapped=bool(os.environ.get("NTLINK_STRESS_GAPPED")))
    if gen_only:
        return 0

    # backend=numpy maps on the host: it takes no device
    device = device_mod.HOST_ONLY if backend == "numpy" else dev
    cuda = device != device_mod.HOST_ONLY and dev.type == "cuda"
    smi = kernel_bench.nvidia_smi() if cuda else None
    if smi:
        print(f"nvidia-smi: {smi}", flush=True)
    os.chdir(workdir)
    tracer = tracing.enable()
    if cuda:
        tracer.device = dev
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = ScaffoldConfig(target="target.fa", reads=["reads.fa"], k=scale.K,
                         w=scale.W, z=scale.Z, backend=backend)
    t0 = time.time()
    final = pipeline.run_scaffold(cfg, gap_fill=True, device=device)
    total_s = time.time() - t0
    print(f"TOTAL scaffold+gap_fill: {total_s:.1f}s", flush=True)
    peak_rss = scale.peak_rss_gib()
    walls = stage_walls(tracer, total_s)
    peaks = {name: b / 2**20 for name, b in tracer.device_peak_bytes.items()}
    # the tracer restarts the device's peak at every top-level stage: the
    # run's peak is the largest stage's (the table is built inside
    # pair/map-reads)
    peak_dev = max(peaks.values(), default=0.0) if cuda else None
    rss = {s.name: s.max_rss_kb / 2**20 for s in tracer.spans}
    for name, secs in walls.items():
        print(f"stage {name}: {'-' if secs is None else f'{secs:.2f}'} s",
              flush=True)
    for s in tracer.spans:
        print(f"span {s.name}: wall {s.wall_s:.2f} s, peak device "
              + (f"{peaks[s.name]:.1f} MiB" if s.name in peaks else "-")
              + f", peak RSS {rss[s.name]:.2f} GiB", flush=True)
    mapper = pipeline.last_hybrid or pipeline.last_mapper
    n_mapped = (mapper.device_reads + getattr(mapper, "host_fallbacks", 0)
                + getattr(mapper, "host_reads", 0)) if mapper else args.n_reads
    rate = n_mapped / pipeline.last_map_seconds
    print(f"mapping: {n_mapped} reads in {pipeline.last_map_seconds:.1f} s "
          f"= {rate:.1f} reads/s", flush=True)
    print(f"peak RSS: {peak_rss:.2f} GiB"
          + (f"; peak device memory {peak_dev:.1f} MiB" if cuda else ""),
          flush=True)

    paths = list(read_path_file(cfg.resolved_prefix()
                                + ".trimmed_scafs.path"))
    joined = sum(len([t for t in toks if not t.endswith("N")]) - 1
                 for _, toks in paths)
    print(f"paths: {len(paths)}; joins made: {joined}/{args.n_contigs - 1}",
          flush=True)
    table = {}
    if pipeline.last_mapper is not None \
            and pipeline.last_mapper.index_sharding != "hash":
        didx = pipeline.last_mapper.didx
        table = {"nb": int(didx.t_bkt.shape[0]),
                 "max_probes": didx.max_probes,
                 "bytes": int(didx.t_bkt.nbytes),
                 "minimizers": len(pipeline.last_mapper.index)}
    # the contig sketcher (TorchHybridSketcher at the default knobs: its
    # counters are the card path's, beside each path's contigs)
    sk = pipeline.last_sketcher
    print(json.dumps({
        "dataset": {"n_contigs": args.n_contigs,
                    "contig_len": args.contig_len, "n_reads": args.n_reads,
                    "read_len": scale.READ_LEN,
                    "gapped": bool(os.environ.get("NTLINK_STRESS_GAPPED"))},
        "backend": backend,
        "device": (torch.cuda.get_device_name(dev) if cuda
                   else "host" if device == device_mod.HOST_ONLY
                   else str(dev)),
        "nvidia_smi": smi,
        "stages_wall_s": walls,
        "stage_peak_device_mib": peaks,
        "stage_peak_rss_gib": rss,
        "mapping_reads": n_mapped,
        "mapping_reads_per_s": rate,
        "peak_rss_gib": peak_rss,
        "peak_device_mib": peak_dev,
        "table": table,
        "sketch_launches": getattr(sk, "kernel_launches", None),
        "sketch_device_batches": (sum(sk.batches_by_pad.values())
                                  if sk is not None else None),
        "sketch_card_contigs": getattr(sk, "device_seqs", None),
        "sketch_host_contigs": getattr(sk, "host_seqs", None),
        "read_launches": getattr(pipeline.last_mapper, "kernel_launches",
                                 None),
        "joins": joined,
        "joins_expected": args.n_contigs - 1,
        "final": os.path.join(workdir, final),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
