"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the checkout and holds it against its
plain PyTorch version on the batches the mapper gives it (B x pad = the
mapper's batch of bases, at pads 1024 .. 2^21). Then it drives the `pair`
stage through the port's CLI on a synthetic genome at C. elegans scale, and
holds its artifacts byte for byte against the same stage run on the CPU,
where every batch goes through the kernel's plain version. Every phase
prints a line; any failure exits non-zero before the last line, which is
the JSON result. Without a CUDA device it exits 1.
"""
from __future__ import annotations

import filecmp
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ntlink_tpu_torch import cli, pipeline
from ntlink_tpu_torch.device_map import batch_rows
from ntlink_tpu_torch.ops import build, sketch_cuda, sketch_torch

SEED = 20261016
KW_GRID = [(32, 100), (24, 250), (15, 5), (40, 100)]
PADS = (1024, 16384, 131072, 1 << 21)
TIME_CASE = (32, 100, 16384)   # timed after its exact check
KERNEL_SOURCE = "ntlink_tpu_torch/csrc/sketch.cu"
# both Pallas entry points (single tile and chunked) map onto one kernel
REPLACES = "ntlink_tpu/ops/sketch_pallas.py:260"
ALSO_REPLACES = "ntlink_tpu/ops/sketch_pallas.py:156"

# phase 2: a synthetic genome at C. elegans scale
N_CONTIGS, CONTIG_LEN, GAP = 2000, 50_000, 500
N_READS, READ_MEDIAN, READ_MIN, READ_MAX = 20_000, 12_000, 1_000, 150_000
SUB_RATE = 0.05
PAIR_ARGV = ["pair", "target=target.fa", "reads=reads.fa", "k=32", "w=100",
             "z=1000", "pairs_tsv=True"]
ARTIFACTS = (".n1.scaffold.dot", ".pairs.tsv", ".verbose_mapping.tsv")


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def edge_specs(L: int, k: int, w: int):
    """(length, fill) of the rows every batch shape must get right: length
    L; two lengths whose last window is the first, then the last, window of
    a 1024-column kernel segment; k+w-1 (one window); k+w-2 (none); k-1
    and 0 (no k-mer); then two full rows whose keys repeat (all-A and
    period-2), so each winner hinges on the leftmost-tie rule across every
    segment seam. fill None means random bases."""
    seam = min(L, (L // 1024 - 1) * 1024 + k + w - 1)
    lengths = [L, seam, seam - 1, k + w - 1, k + w - 2, k - 1, 0]
    return [(n, None) for n in lengths] + [(L, (0,)), (L, (2, 1))]


def edge_batches(rng, B: int, L: int, k: int, w: int):
    """Yield (codes, lengths) batches of B rows at pad L that together hold
    every edge row, each at the top of its batch; the other rows take
    random bases and lengths."""
    specs = edge_specs(L, k, w)
    for first in range(0, len(specs), B):
        codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
        lengths = rng.integers(max(L // 2, k + w), L + 1, B).astype(np.int32)
        for row, (n, fill) in enumerate(specs[first : first + B]):
            lengths[row] = n
            if fill is not None:
                codes[row] = np.resize(np.array(fill, np.uint8), L)
        yield codes, lengths


def compare(out, ref, lengths, k):
    """Exact comparison on the valid region; returns max |kernel - plain|
    over every compared value (0.0 when equal, inf when a hash differs)."""
    can, fwd, winner, emit = out
    r_can, r_fwd, r_win, r_emit = ref
    L = can.shape[1]
    valid = (
        torch.arange(L, device=can.device)[None, :]
        <= (lengths.long() - k)[:, None]
    )
    if not torch.equal(can[valid], r_can[valid]):
        return float("inf")
    errs = [
        (fwd[valid].int() - r_fwd[valid].int()).abs().max(),
        (winner.long() - r_win.long()).abs().max(),
        (emit.int() - r_emit.int()).abs().max(),
    ]
    return max(float(e) for e in errs if e.numel())


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of `fn` over `reps` runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 0: nvidia-smi: {smi}")
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build("sketch")
    log(f"phase 0: nvcc build of {KERNEL_SOURCE}: "
        f"{build.build_seconds['sketch']:.2f} s compile "
        f"({time.perf_counter() - t0:.2f} s wall)")
    return smi


def phase_kernel(dev) -> dict:
    """Kernel vs plain version at the mapper's batch shape for each pad."""
    batch_bases = cli.pair_config(PAIR_ARGV).batch_bases
    rng = np.random.default_rng(SEED)
    worst, ms, plain_ms = 0.0, None, None
    for k, w in KW_GRID:
        for L in PADS:
            B = batch_rows(L, batch_bases)
            for codes_np, lengths_np in edge_batches(rng, B, L, k, w):
                codes = torch.from_numpy(codes_np).to(dev)
                lengths = torch.from_numpy(lengths_np).to(dev)
                out = sketch_cuda.sketch_rows(codes, lengths, k, w)
                ref = sketch_torch.sketch_rows_ref(codes, lengths, k, w)
                torch.cuda.synchronize()
                err = compare(out, ref, lengths, k)
                log(f"phase 1: k={k} w={w} pad={L} B={B}: "
                    f"max_abs_err={err}")
                if err != 0.0:
                    fail(f"kernel != plain version at k={k} w={w} pad={L}")
                worst = max(worst, err)
                del out, ref
                if (k, w, L) == TIME_CASE and ms is None:
                    ms = cuda_ms(
                        lambda: sketch_cuda.sketch_rows(codes, lengths, k, w)
                    )
                    plain_ms = cuda_ms(lambda: sketch_torch.sketch_rows_ref(
                        codes, lengths, k, w
                    ))
                    log(f"phase 1: B={B} x pad={L} (k={k} w={w}): kernel "
                        f"{ms:.3f} ms, plain version {plain_ms:.3f} ms "
                        f"(median of 10)")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def write_dataset(d: str) -> None:
    """2,000 contigs of 50 kb cut from a 101 Mbp random genome, 500 b gaps
    left out of the draft; 20,000 reads, log-normal lengths (median 12 kb,
    clipped to 1-150 kb) with 5% substitutions, half reverse-complemented.
    Coverage is ~3x, cut from the usual 20-40x to keep the smoke short."""
    rng = np.random.default_rng(SEED + 1)
    ascii_ = np.frombuffer(b"ACGT", np.uint8)
    span = CONTIG_LEN + GAP
    genome = rng.integers(0, 4, N_CONTIGS * span - GAP, dtype=np.uint8)
    with open(os.path.join(d, "target.fa"), "wb") as fh:
        for i in range(N_CONTIGS):
            seq = ascii_[genome[i * span : i * span + CONTIG_LEN]]
            fh.write(b">contig%d\n" % i + seq.tobytes() + b"\n")
    lens = np.clip(
        np.exp(rng.normal(np.log(READ_MEDIAN), 0.7, N_READS)),
        READ_MIN, READ_MAX,
    ).astype(np.int64)
    starts = rng.integers(0, len(genome) - lens)
    with open(os.path.join(d, "reads.fa"), "wb") as fh:
        for r in range(N_READS):
            read = genome[starts[r] : starts[r] + lens[r]].copy()
            sub = rng.random(lens[r]) < SUB_RATE
            read[sub] = (read[sub] + rng.integers(1, 4, sub.sum())) % 4
            if r % 2:
                read = (3 - read)[::-1]
            fh.write(b">read%d\n" % r + ascii_[read].tobytes() + b"\n")
    log(f"phase 2: dataset: {N_CONTIGS} contigs x {CONTIG_LEN} b, "
        f"{N_READS} reads, {int(lens.sum())} read bases "
        f"({lens.sum() / (N_CONTIGS * CONTIG_LEN):.2f}x), "
        f"longest {int(lens.max())} b")


def run_in(d: str, fn):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def phase_slice(dev) -> int:
    with tempfile.TemporaryDirectory(prefix="ntlink_smoke_") as root:
        t0 = time.perf_counter()
        data = os.path.join(root, "data")
        os.makedirs(data)
        write_dataset(data)
        log(f"phase 2: dataset written in {time.perf_counter() - t0:.1f} s")
        runs = {}
        for side in ("card", "cpu"):
            d = os.path.join(root, side)
            os.makedirs(d)
            for f in ("target.fa", "reads.fa"):
                os.symlink(os.path.join(data, f), os.path.join(d, f))
            runs[side] = d

        # the main path: the port's CLI, on the card
        sketch_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        rc = run_in(runs["card"], lambda: cli.main(PAIR_ARGV))
        card_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = sketch_cuda.launches
        peak = torch.cuda.max_memory_allocated(dev)
        if rc != 0:
            fail(f"port pair exited {rc}")
        mapper = pipeline.last_mapper
        n_reads = mapper.device_reads + mapper.host_fallbacks
        log(f"phase 2: port pair on the card: {card_s:.1f} s total; mapping "
            f"{n_reads} reads in {mapper.stream_seconds:.3f} s = "
            f"{n_reads / mapper.stream_seconds:.1f} reads/s; {launches} "
            f"sketch kernel launches; batches by pad "
            f"{mapper.batches_by_pad}; {mapper.host_fallbacks} host-fallback "
            f"reads; peak device memory {peak / 2**20:.1f} MiB")
        if n_reads != N_READS:
            fail(f"port mapped {n_reads} reads, expected {N_READS}")
        if launches == 0:
            fail("the main path launched no sketch kernel")
        if mapper.host_fallbacks > N_READS // 100:
            fail(f"{mapper.host_fallbacks} host-fallback reads (> 1%)")
        if max(mapper.batches_by_pad) <= 16384:
            fail("no batch in the pad > 16384 domain")

        # the reference: the same stage on the CPU, where every batch goes
        # through the kernel's plain version
        t0 = time.perf_counter()
        run_in(runs["cpu"], lambda: pipeline.pair_stage(
            cli.pair_config(PAIR_ARGV), device="cpu"
        ))
        log(f"phase 2: port pair on the CPU (plain version): "
            f"{time.perf_counter() - t0:.1f} s")
        prefix = "target.fa.k32.w100.z1000"
        for art in ARTIFACTS:
            a = os.path.join(runs["card"], prefix + art)
            b = os.path.join(runs["cpu"], prefix + art)
            if not (os.path.getsize(a) > 0 and filecmp.cmp(a, b,
                                                          shallow=False)):
                fail(f"{prefix}{art} differs between the card and the CPU")
            log(f"phase 2: {prefix}{art}: byte-identical "
                f"({os.path.getsize(a)} bytes)")
        with open(os.path.join(runs["card"], prefix + ".n1.scaffold.dot")) as fh:
            edges = sum(" -> " in line for line in fh)
        if edges == 0:
            fail("scaffold graph has no edges")
        log(f"phase 2: scaffold graph edges: {edges}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    kern = phase_kernel(dev)
    launches = phase_slice(dev)
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [{
        "name": "sketch_rows",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "also_replaces": ALSO_REPLACES,
        "launches": launches,
        **kern,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
