"""Throughput scaling measurement of the PyTorch port, in two legs.

    python3 scripts/measure_scaling_torch.py OUT.json [--device cpu]
        [--max-n N] [--reads N] [--rank-reads N]

The counterpart of ``scripts/measure_scaling.py``, on the same workload
(``bench.make_dataset`` of the port: contigs of 250 kb from
``default_rng(42)``, reads of 12 kb across their junctions):

A. One batch stream split over n devices: `TorchMapper(devices=[dev] * n)`
   for n = 1/2/4/8 (the original's virtual CPU devices), mapping `--reads`
   reads after a 64-read warm-up. The n replicas share one device, so the
   wall cannot improve; the number is the CPU-seconds overhead of the split
   (`cpu_overhead_vs_1dev` = cpu_n / cpu_1).
B. n = 1/2/4 processes over the shared-directory transport (`DirTransport`,
   NTLINK_GROUP_DIR): a fixed set of 8 read files sharded by file, each rank
   mapping its share with backend=numpy t=1 (host only), then the
   file-ordered tally all-gather. Every rank count must give the same tally
   (its digest, `tally_sha`); `efficiency` = T_1 / (n * T_n) on the host's
   cores.

Neither leg is a scaling figure for cards: the card's machine has one H100,
so leg A's replicas share it (device "cuda:0" named n times) and leg B
never touches it; each row says so under `shared`. The JSON goes to OUT
only, which must not be one of the repository's ``SCALING_r0*.json``
records. Leg A runs on the card by default; without one the script exits
1 unless `--device cpu` is given. `--max-n`, `--reads` and `--rank-reads`
shrink the run (the tests).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from ntlink_tpu_torch import bench, pipeline  # noqa: E402
from ntlink_tpu_torch import device as device_mod  # noqa: E402
from ntlink_tpu_torch.config import ScaffoldConfig  # noqa: E402
from ntlink_tpu_torch.device_map import TorchMapper  # noqa: E402
from ntlink_tpu_torch.index import ContigIndex  # noqa: E402
from ntlink_tpu_torch.ops import nthash_np  # noqa: E402
from ntlink_tpu_torch.pairs import PairTally  # noqa: E402
from ntlink_tpu_torch.parallel.distributed import (  # noqa: E402
    all_gather_file_tallies, maybe_init_distributed,
)
from ntlink_tpu_torch.sketch import sketch_fasta_to_tsv  # noqa: E402

K, W, Z = bench.K, bench.W, bench.Z
N_CONTIGS, CONTIG_LEN, READ_LEN = 8, 250_000, 12_000
LEG_A_READS, LEG_B_READS = 768, 8000
LEG_A_NS, LEG_B_NS = (1, 2, 4, 8), (1, 2, 4)
READ_FILES = 8
WARM_READS = 64
RANK_TIMEOUT_S = 1200


def make_dataset(n_reads: int):
    """(contigs, reads) of ``measure_scaling.make_dataset``."""
    return bench.make_dataset(
        np.random.default_rng(42), n_contigs=N_CONTIGS,
        contig_len=CONTIG_LEN, n_reads=n_reads, read_len=READ_LEN)


def leg_a(dev: torch.device, n_reads: int, max_n: int) -> list:
    """CPU seconds of one stream split over n replicas on `dev`."""
    contigs, reads = make_dataset(n_reads)
    index = ContigIndex.from_sketches(
        (n, nthash_np.sketch_sequence(s, K, W)) for n, s in contigs.items())
    codes = [(n, nthash_np.encode(s)) for n, s in reads]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rows = []
    for n_dev in (n for n in LEG_A_NS if n <= max_n):
        mapper = TorchMapper(index, K, W, batch_bases=8_000_000,
                             devices=[dev] * n_dev)
        for _ in mapper.map_stream_raw(iter(codes[:WARM_READS])):
            pass
        sync()
        t0w, t0c = time.perf_counter(), time.process_time()
        n = sum(1 for _ in mapper.map_stream_raw(iter(codes)))
        sync()
        rows.append({
            "n_devices": n_dev, "devices": [str(d) for d in mapper.devices],
            "reads": n, "wall_s": time.perf_counter() - t0w,
            "cpu_s": time.process_time() - t0c,
            "launches_by_device": mapper.launches_by_device(),
            "shared": f"{n_dev} replicas on one {dev} device",
        })
        print(f"# split over {n_dev} x {dev}: {rows[-1]}", file=sys.stderr)
    base = rows[0]["cpu_s"]
    for row in rows:
        row["cpu_overhead_vs_1dev"] = row["cpu_s"] / base
    return rows


def rank_main(argv) -> int:
    """One rank of leg B: map this rank's read files, then all-gather the
    per-file tallies; prints one JSON line."""
    workdir, tsv, *read_files = argv
    os.chdir(workdir)
    pid, n = maybe_init_distributed()
    index = ContigIndex.from_tsv(tsv)
    contig_lengths = pipeline.read_scaffold_lengths("target.fa")
    cfg = ScaffoldConfig(k=K, w=W, z=Z, backend="numpy", t=1,
                         reads=read_files)
    mapper = pipeline.make_mapper(cfg, index, contig_lengths, None)
    t0, c0 = time.perf_counter(), time.process_time()
    per_file = {}
    for fi, rf in enumerate(read_files):
        if fi % n == pid:
            per_file[fi] = pipeline.map_reads(
                dataclasses.replace(cfg, reads=[rf]), index, contig_lengths,
                None, None, mapper)
    map_s = time.perf_counter() - t0
    map_cpu_s = time.process_time() - c0
    t1 = time.perf_counter()
    tally = all_gather_file_tallies(
        per_file, PairTally(contig_lengths, cfg.k, cfg.f))
    allgather_s = time.perf_counter() - t1
    sig = sorted((str(pk), tuple(ev.gap_estimates), ev.anchor)
                 for pk, ev in tally.pairs.items())
    print(json.dumps({
        "rank": pid, "map_s": map_s + allgather_s, "map_only_s": map_s,
        "map_cpu_s": map_cpu_s, "allgather_s": allgather_s,
        "pairs": len(tally.pairs),
        "tally_sha": hashlib.sha256(repr(sig).encode()).hexdigest()[:16],
    }), flush=True)
    return 0


def leg_b(tmp: str, n_reads: int, max_n: int) -> list:
    """n ranks over DirTransport on a fixed set of read files."""
    contigs, reads = make_dataset(n_reads)
    with open(os.path.join(tmp, "target.fa"), "w") as fh:
        for name, seq in contigs.items():
            fh.write(f">{name}\n{seq}\n")
    files = []
    for i in range(READ_FILES):
        files.append(f"reads{i}.fa")
        bench.write_reads(os.path.join(tmp, files[-1]), reads[i::READ_FILES])
    tsv = os.path.join(tmp, "target.k32.w100.tsv")
    sketch_fasta_to_tsv(os.path.join(tmp, "target.fa"), tsv, K, W)
    rows = []
    for n_proc in (n for n in LEG_B_NS if n <= max_n):
        procs = []
        t0 = time.perf_counter()
        for pid in range(n_proc):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("NTLINK_")}
            env["PYTHONPATH"] = REPO
            if n_proc > 1:
                env.update(NTLINK_GROUP_DIR=os.path.join(tmp,
                                                         f"group{n_proc}"),
                           NTLINK_NUM_PROCESSES=str(n_proc),
                           NTLINK_PROCESS_ID=str(pid))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", tmp,
                 tsv, *files],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        ranks = []
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                raise RuntimeError(f"a rank of {n_proc} exited "
                                   f"{p.returncode}:\n{err[-3000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
        shas = {r["tally_sha"] for r in ranks}
        if len(shas) != 1:
            raise RuntimeError(f"the ranks' tallies differ: {shas}")
        slowest = max(r["map_s"] for r in ranks)
        rows.append({
            "n_processes": n_proc,
            "map_s_slowest_rank": slowest,
            "map_cpu_s_total": sum(r["map_cpu_s"] for r in ranks),
            "allgather_s_max": max(r["allgather_s"] for r in ranks),
            "wall_s_incl_startup": time.perf_counter() - t0,
            "reads_per_s": len(reads) / slowest,
            "pairs": ranks[0]["pairs"],
            "tally_sha": ranks[0]["tally_sha"],
            "shared": f"{n_proc} processes on this host's "
                      f"{os.cpu_count()} cores, backend=numpy t=1 (no "
                      f"device)",
        })
        print(f"# dirtransport {rows[-1]}", file=sys.stderr)
    t1, cpu1, sha1 = (rows[0][k] for k in
                      ("map_s_slowest_rank", "map_cpu_s_total", "tally_sha"))
    for row in rows:
        if row["tally_sha"] != sha1:
            raise RuntimeError("the tally differs across rank counts")
        row["speedup"] = t1 / row["map_s_slowest_rank"]
        row["efficiency"] = t1 / (row["n_processes"]
                                  * row["map_s_slowest_rank"])
        row["cpu_efficiency"] = cpu1 / row["map_cpu_s_total"]
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        return rank_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="where the JSON goes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu must be asked for")
    ap.add_argument("--max-n", type=int, default=max(LEG_A_NS))
    ap.add_argument("--reads", type=int, default=LEG_A_READS,
                    help="reads of leg A")
    ap.add_argument("--rank-reads", type=int, default=LEG_B_READS,
                    help="reads of leg B, over 8 files")
    args = ap.parse_args(argv)
    if re.fullmatch(r"SCALING_r0\d*\.json", os.path.basename(args.out)) \
            and os.path.exists(args.out):
        ap.error(f"{args.out} is a record of the repository; name another "
                 f"file")
    try:
        dev = device_mod.resolve(args.device)
    except RuntimeError as exc:
        print(f"measure_scaling_torch: {exc} (give --device cpu to run on "
              f"the host)", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="ntscale_") as tmp:
        payload = {
            "host_cores": os.cpu_count(),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else str(dev)),
            "device_count": (torch.cuda.device_count()
                             if dev.type == "cuda" else 0),
            "split_over_replicas": leg_a(dev, args.reads, args.max_n),
            "multi_process_dirtransport": leg_b(tmp, args.rank_reads,
                                                args.max_n),
            "note": (
                "no scaling figure: leg A's replicas share one device, so "
                "only its CPU-second overhead means anything; leg B's ranks "
                "map on the host's cores (backend=numpy) and never touch a "
                "device"
            ),
        }
    with open(args.out, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
