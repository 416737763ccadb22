"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout and holds each against its
plain PyTorch version. Phase 1: the sketch kernel on the batches the main
path gives it (the mapper's batch of bases at pads 1024 .. 2^21, and the
contig sketcher's 8 x 2^21). Phase 1b: the integer peak probe (the
counterpart of bench.py's Pallas microkernel) at (256, 1024), bit for bit,
then its rates by width. Then it drives the port's CLI on a synthetic
draft at C. elegans scale with N gaps and two contigs past 2^21 bases
(phase 2): 2a, the default `pair` run (contig sketch on the card,
chaining on the card, per-anchor payload), held byte for byte against the
same stage on the CPU, where every batch goes through the kernel's plain
version; 2b, the lean run (verbose=False: O(runs) payload), held against
2a; 2c, the host-chained path (sensitive=True) on 2,000 reads, card vs
CPU. Phase 3: backend=hybrid t=4 (card and host C path at once), verbose
and lean, held against 2a and 2b. Phase 4: repeats=True (hash planes) on
2,000 reads, card vs CPU. Phase 5: `run_rounds_gaps rounds=2` on a smaller
draft cut the same way, card vs CPU, every file of the run; round 2 must
launch no sketch kernel. Phase 6: the kernel bench
(``python -m ntlink_tpu_torch.kernel_bench``), its JSON on a line of its
own. Every phase prints a line; any failure exits non-zero before the last
line, which is the JSON result. Without a CUDA device it exits 1.
"""
from __future__ import annotations

import filecmp
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ntlink_tpu_torch import cli, kernel_bench, pipeline
from ntlink_tpu_torch.device_map import batch_rows
from ntlink_tpu_torch.ops import alu_peak_cuda, build, sketch_cuda, sketch_torch
from ntlink_tpu_torch.ops.alu_peak_torch import WIDTHS, alu_peak_ref
from ntlink_tpu_torch.sketch import TorchHybridSketcher, TorchSketcher

SEED = 20261016
KW_GRID = [(32, 100), (24, 250), (15, 5), (40, 100)]
PADS = (1024, 16384, 131072, 1 << 21)
CONTIG_PAD = 1 << 21
# timed after their exact check: (k, w, B, pad) of a read batch and of a
# contig batch
TIME_CASES = ((32, 100, 512, 16384), (32, 100, 8, CONTIG_PAD))
KERNEL_SOURCE = "ntlink_tpu_torch/csrc/sketch.cu"
# both Pallas entry points (single tile and chunked) map onto one kernel
REPLACES = "ntlink_tpu/ops/sketch_pallas.py:260"
ALSO_REPLACES = "ntlink_tpu/ops/sketch_pallas.py:156"
PROBE_SOURCE = "ntlink_tpu_torch/csrc/alu_peak.cu"
PROBE_REPLACES = "bench.py:273"
PROBE_ITERS = (1, 7, 64)

# phase 2: a synthetic genome at C. elegans scale
N_CONTIGS, CONTIG_LEN, GAP = 2000, 50_000, 500
N_LONG, LONG_LEN = 2, 3_000_000         # past MAX_PAD: the stream chunks them
N_GAPPED, N_RUN = 200, 100              # contigs with an N run in the middle
N_READS, READ_MEDIAN, READ_MIN, READ_MAX = 20_000, 12_000, 1_000, 150_000
N_SUBK = 2                               # sub-k reads: the exact host path
SUB_RATE, N_READ_SHARE = 0.05, 0.01
PAIR_ARGV = ["pair", "target=target.fa", "reads=reads.fa", "k=32", "w=100",
             "z=1000", "pairs_tsv=True"]
LEAN_ARGV = PAIR_ARGV + ["verbose=False"]
SENS_READS = 2_000
SENS_ARGV = ["pair", "target=target.fa", "reads=reads2k.fa", "k=32",
             "w=100", "z=1000", "pairs_tsv=True", "sensitive=True"]
PREFIX = "target.fa.k32.w100.z1000"
CONTIG_TSV = "target.fa.k32.w100.tsv"
ARTIFACTS = (".n1.scaffold.dot", ".pairs.tsv", ".verbose_mapping.tsv")
HYBRID_ARGV = PAIR_ARGV + ["backend=hybrid", "t=4"]
REPEATS_ARGV = ["pair", "target=target.fa", "reads=reads2k.fa", "k=32",
                "w=100", "z=1000", "pairs_tsv=True", "repeats=True"]
# phase 5: a smaller draft cut the same way, scaffolded in two rounds
SMALL = dict(n_contigs=500, n_long=1, n_gapped=50, n_reads=6_000)
ROUNDS_ARGV = ["run_rounds_gaps", "target=target.fa", "reads=reads.fa",
               "k=32", "w=100", "z=1000", "rounds=2"]


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
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(build.build, ("sketch", "alu_peak")))
    log(f"phase 0: nvcc builds of {KERNEL_SOURCE}: "
        f"{build.build_seconds['sketch']:.2f} s, of {PROBE_SOURCE}: "
        f"{build.build_seconds['alu_peak']:.2f} s compile "
        f"({time.perf_counter() - t0:.2f} s wall)")
    return smi


def batch_shapes(batch_bases: int):
    """(B, pad) of every batch the main path gives the kernel: the mapper's
    heights at each pad, and the contig sketcher's at 2^21."""
    shapes = [(batch_rows(L, batch_bases), L) for L in PADS]
    shapes.append((batch_rows(CONTIG_PAD, TorchSketcher("cpu").batch_bases),
                   CONTIG_PAD))
    return shapes


def phase_kernel(dev) -> dict:
    """Kernel vs plain version at the main path's batch shapes."""
    batch_bases = cli.parse(PAIR_ARGV)[1].batch_bases
    rng = np.random.default_rng(SEED)
    worst = 0.0
    times = {}
    for k, w in KW_GRID:
        for B, L in batch_shapes(batch_bases):
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
                    fail(f"kernel != plain version at k={k} w={w} pad={L} "
                         f"B={B}")
                worst = max(worst, err)
                del out, ref
                if (k, w, B, L) in TIME_CASES and (B, L) not in times:
                    ms = cuda_ms(
                        lambda: sketch_cuda.sketch_rows(codes, lengths, k, w)
                    )
                    plain_ms = cuda_ms(lambda: sketch_torch.sketch_rows_ref(
                        codes, lengths, k, w
                    ))
                    times[(B, L)] = (ms, plain_ms)
                    log(f"phase 1: B={B} x pad={L} (k={k} w={w}): kernel "
                        f"{ms:.3f} ms, plain version {plain_ms:.3f} ms "
                        f"(median of 10)")
    (ms, plain_ms), (c_ms, c_plain_ms) = (times[c[2:]] for c in TIME_CASES)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "contig_batch_ms": c_ms, "contig_batch_plain_ms": c_plain_ms}


def write_dataset(d: str, n_contigs: int = N_CONTIGS, n_long: int = N_LONG,
                  n_gapped: int = N_GAPPED, n_reads: int = N_READS,
                  label: str = "phase 2") -> None:
    """By default 2,000 contigs of 50 kb and 2 of 3 Mb cut from a 107 Mbp
    random genome, 500 b gaps left out of the draft, a run of 100 N in the
    middle of 200 of the 50 kb contigs; 20,000 reads, log-normal lengths
    (median 12 kb, clipped to 1-150 kb) with 5% substitutions, half
    reverse-complemented, one N in 1% of them, then 2 sub-k reads; and
    reads2k.fa, the first 2,000 reads. Coverage is ~3x, cut from the usual
    20-40x to keep the smoke short. The counts scale the draft down the
    same way (phase 5)."""
    rng = np.random.default_rng(SEED + 1)
    ascii_ = np.frombuffer(b"ACGTN", np.uint8)
    lens = [CONTIG_LEN] * n_contigs + [LONG_LEN] * n_long
    starts = np.concatenate([[0], np.cumsum(np.asarray(lens) + GAP)])
    genome = rng.integers(0, 4, int(starts[-1]) - GAP, dtype=np.uint8)
    gapped = set(rng.choice(n_contigs, n_gapped, replace=False).tolist())
    with open(os.path.join(d, "target.fa"), "wb") as fh:
        for i, n in enumerate(lens):
            seq = genome[starts[i] : starts[i] + n].copy()
            if i in gapped:
                mid = (n - N_RUN) // 2
                seq[mid : mid + N_RUN] = 4
            fh.write(b">contig%d\n" % i + ascii_[seq].tobytes() + b"\n")
    rlens = np.clip(
        np.exp(rng.normal(np.log(READ_MEDIAN), 0.7, n_reads)),
        READ_MIN, READ_MAX,
    ).astype(np.int64)
    rstarts = rng.integers(0, len(genome) - rlens)
    with_n = rng.random(n_reads) < N_READ_SHARE
    with open(os.path.join(d, "reads.fa"), "wb") as fh, \
            open(os.path.join(d, "reads2k.fa"), "wb") as fh2k:
        for r in range(n_reads):
            read = genome[rstarts[r] : rstarts[r] + rlens[r]].copy()
            sub = rng.random(rlens[r]) < SUB_RATE
            read[sub] = (read[sub] + rng.integers(1, 4, sub.sum())) % 4
            if r % 2:
                read = (3 - read)[::-1]
            if with_n[r]:
                read[rng.integers(0, len(read))] = 4
            rec = b">read%d\n" % r + ascii_[read].tobytes() + b"\n"
            fh.write(rec)
            if r < SENS_READS:
                fh2k.write(rec)
        for r in range(N_SUBK):
            fh.write(b">short%d\nACGTACGTAC\n" % r)
    log(f"{label}: dataset: {n_contigs} contigs x {CONTIG_LEN} b "
        f"({n_gapped} with {N_RUN} N) + {n_long} x {LONG_LEN} b; "
        f"{n_reads} reads ({int(with_n.sum())} with an N) + {N_SUBK} sub-k, "
        f"{int(rlens.sum())} read bases "
        f"({rlens.sum() / sum(lens):.2f}x), longest {int(rlens.max())} b")


def run_in(d: str, fn):
    cwd = os.getcwd()
    os.chdir(d)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def make_dir(root: str, name: str, links) -> str:
    """root/name holding symlinks to `links` (paths)."""
    d = os.path.join(root, name)
    os.makedirs(d)
    for src in links:
        os.symlink(src, os.path.join(d, os.path.basename(src)))
    return d


def card_pair(d: str, argv, dev, label: str):
    """The port's CLI on the card in `d`, with the launch count set to 0
    just before and read just after. Returns (mapper, sketcher or None,
    launches, wall seconds)."""
    pipeline.last_sketcher = None
    sketch_cuda.launches = 0
    t0 = time.perf_counter()
    rc = run_in(d, lambda: cli.main(argv))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = sketch_cuda.launches
    if rc != 0:
        fail(f"{label}: port pair exited {rc}")
    if launches == 0:
        fail(f"{label}: the main path launched no sketch kernel")
    mapper, sketcher = pipeline.last_mapper, pipeline.last_sketcher
    # backend=hybrid: the card's share of the contig stream
    card_sk = getattr(sketcher, "device_backend", sketcher)
    n = mapper.device_reads + mapper.host_fallbacks
    log(f"{label}: port pair on the card: {secs:.1f} s total; mapping {n} "
        f"reads in {mapper.stream_seconds:.3f} s = "
        f"{n / mapper.stream_seconds:.1f} reads/s "
        f"(prechained={mapper.prechained}, runs_only={mapper.runs_only}); "
        f"{launches} sketch kernel launches ({mapper.kernel_launches} read "
        f"mapping"
        + (f", {card_sk.kernel_launches} contig sketch" if card_sk else "")
        + f"); read batches by (pad, has N) {mapper.batches_by_pad}; "
        f"{mapper.host_fallbacks} host-fallback reads")
    if card_sk is not None:
        log(f"{label}: contig sketch on the card: "
            f"{card_sk.stream_seconds:.3f} s; {card_sk.device_rows} device "
            f"rows, {card_sk.chunked} chunked contigs, batches by (pad, has "
            f"N) {card_sk.batches_by_pad}; {card_sk.host_fallbacks} "
            f"host-fallback rows")
    return mapper, sketcher, launches, secs


def cpu_pair(d: str, argv, label: str) -> None:
    t0 = time.perf_counter()
    run_in(d, lambda: pipeline.pair_stage(cli.parse(argv)[1],
                                          device="cpu"))
    log(f"{label}: port pair on the CPU (plain version): "
        f"{time.perf_counter() - t0:.1f} s")


def same_bytes(label: str, a_dir: str, b_dir: str, names) -> None:
    for name in names:
        a, b = os.path.join(a_dir, name), os.path.join(b_dir, name)
        if not (os.path.getsize(a) > 0
                and filecmp.cmp(a, b, shallow=False)):
            fail(f"{label}: {name} differs")
        log(f"{label}: {name}: byte-identical ({os.path.getsize(a)} bytes)")


def phase_slice(dev) -> dict:
    with tempfile.TemporaryDirectory(prefix="ntlink_smoke_") as root:
        t0 = time.perf_counter()
        data = os.path.join(root, "data")
        os.makedirs(data)
        write_dataset(data)
        log(f"phase 2: dataset written in {time.perf_counter() - t0:.1f} s")
        inputs = [os.path.join(data, f) for f in ("target.fa", "reads.fa")]
        n_reads = N_READS + N_SUBK

        # 2a, the main path: the default run (verbose, prechained) on the
        # card, then the same stage on the CPU (plain version in every batch)
        card = make_dir(root, "card", inputs)
        torch.cuda.reset_peak_memory_stats(dev)
        mapper, sketcher, launches, _ = card_pair(card, PAIR_ARGV, dev,
                                                  "phase 2a")
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"phase 2a: peak device memory {peak / 2**20:.1f} MiB")
        if mapper.device_reads + mapper.host_fallbacks != n_reads:
            fail(f"2a mapped {mapper.device_reads + mapper.host_fallbacks} "
                 f"reads, expected {n_reads}")
        if not mapper.prechained or mapper.runs_only:
            fail("2a: the default run is not prechained per-anchor")
        if sketcher is None or sketcher.chunked != N_LONG:
            fail("2a: the contig sketch did not chunk the long contigs")
        for what, obj in (("contig", sketcher), ("read", mapper)):
            if not any(has_n for _, has_n in obj.batches_by_pad):
                fail(f"2a: no {what} N batch ran on the card")
        # every input is at least k long but the sub-k reads, so those are
        # the only exact-host rows either stream may have
        if sketcher.host_fallbacks != 0 or mapper.host_fallbacks != N_SUBK:
            fail(f"2a: host fallbacks: {sketcher.host_fallbacks} contig "
                 f"rows, {mapper.host_fallbacks} reads (sub-k: {N_SUBK})")
        if max(L for L, _ in mapper.batches_by_pad) <= 16384:
            fail("2a: no read batch in the pad > 16384 domain")
        cpu = make_dir(root, "cpu", inputs)
        cpu_pair(cpu, PAIR_ARGV, "phase 2a")
        same_bytes("phase 2a", card, cpu,
                   [PREFIX + a for a in ARTIFACTS] + [CONTIG_TSV])
        with open(os.path.join(card, PREFIX + ARTIFACTS[0])) as fh:
            edges = sum(" -> " in line for line in fh)
        if edges == 0:
            fail("scaffold graph has no edges")
        log(f"phase 2a: scaffold graph edges: {edges}")
        by_path = {"2a contig sketch": sketcher.kernel_launches,
                   "2a read mapping": mapper.kernel_launches}

        # 2b: the lean run (verbose=False: runs-only payload) in a fresh
        # directory; its artifacts must be 2a's
        lean = make_dir(root, "lean", inputs)
        mapper_b, sketcher_b, _, _ = card_pair(lean, LEAN_ARGV, dev,
                                               "phase 2b")
        if not mapper_b.runs_only:
            fail("2b: the lean run did not ship runs-only payloads")
        same_bytes("phase 2b", card, lean,
                   [PREFIX + a for a in ARTIFACTS[:2]] + [CONTIG_TSV])
        by_path["2b contig sketch"] = sketcher_b.kernel_launches
        by_path["2b read mapping"] = mapper_b.kernel_launches

        # 2c: the host-chained per-anchor path (sensitive=True) on the
        # first 2,000 reads, card vs CPU, on 2a's contig sketch
        links = [inputs[0], os.path.join(data, "reads2k.fa"),
                 os.path.join(card, CONTIG_TSV)]
        sens_card = make_dir(root, "sens_card", links)
        mapper_c, _, _, _ = card_pair(sens_card, SENS_ARGV, dev, "phase 2c")
        if mapper_c.prechained:
            fail("2c: sensitive=True must chain on the host")
        sens_cpu = make_dir(root, "sens_cpu", links)
        cpu_pair(sens_cpu, SENS_ARGV, "phase 2c")
        same_bytes("phase 2c", sens_card, sens_cpu,
                   [PREFIX + a for a in ARTIFACTS])
        by_path["2c read mapping"] = mapper_c.kernel_launches

        # 3: backend=hybrid t=4, the card and the host's C path at once, in
        # fresh directories (each sketches the contigs); verbose vs 2a, lean
        # vs 2b
        hybrid = {}
        for name, argv, ref_dir, arts in (
            ("hybrid", HYBRID_ARGV, card, ARTIFACTS),
            ("hybrid_lean", HYBRID_ARGV + ["verbose=False"], lean,
             ARTIFACTS[:2]),
        ):
            label = f"phase 3 ({name})"
            d = make_dir(root, name, inputs)
            mapper_h, sketcher_h, _, secs = card_pair(d, argv, dev, label)
            split = pipeline.last_hybrid
            if split is None or not isinstance(sketcher_h,
                                               TorchHybridSketcher):
                fail(f"{label}: the run did not go through the hybrid path")
            n = split.device_reads + split.host_reads
            if n != n_reads:
                fail(f"{label}: mapped {n} reads, expected {n_reads}")
            if split.device_reads == 0:
                fail(f"{label}: the card took no reads")
            rate = n / pipeline.last_map_seconds
            share = split.device_reads / n
            n_seqs = sketcher_h.device_seqs + sketcher_h.host_seqs
            sk_share = sketcher_h.device_seqs / n_seqs
            log(f"{label}: mapping {n} reads in "
                f"{pipeline.last_map_seconds:.3f} s = {rate:.1f} reads/s; "
                f"card share {split.device_reads} reads ({100 * share:.1f}%), "
                f"host {split.host_reads}; contig sketch: card "
                f"{sketcher_h.device_seqs} of {n_seqs} contigs "
                f"({100 * sk_share:.1f}%); {secs:.1f} s total")
            same_bytes(label, ref_dir, d, [PREFIX + a for a in arts]
                       + [CONTIG_TSV])
            hybrid[name] = {"reads_per_s": rate, "device_share": share,
                            "contig_device_share": sk_share}
            by_path[f"3 {name}"] = (mapper_h.kernel_launches
                                    + sketcher_h.device_backend.kernel_launches)

        # 4: repeats=True (hash planes, the repeat filter before host
        # chaining) on the first 2,000 reads, card vs CPU, on 2a's sketch
        rep_card = make_dir(root, "rep_card", links)
        mapper_r, _, _, _ = card_pair(rep_card, REPEATS_ARGV, dev, "phase 4")
        if not mapper_r.with_hashes or mapper_r.prechained:
            fail("4: repeats=True must ship hash planes and chain on the "
                 "host")
        rep_cpu = make_dir(root, "rep_cpu", links)
        cpu_pair(rep_cpu, REPEATS_ARGV, "phase 4")
        same_bytes("phase 4", rep_card, rep_cpu,
                   [PREFIX + a for a in ARTIFACTS])
        by_path["4 repeats"] = mapper_r.kernel_launches
    return {"launches": launches, "launches_by_path": by_path,
            "hybrid": hybrid}


def same_tree(label: str, a_dir: str, b_dir: str, must_have) -> None:
    """Both directories hold the same names, each symlink points at the
    same name and each file holds the same bytes; `must_have` are there."""
    names = sorted(os.listdir(a_dir))
    if names != sorted(os.listdir(b_dir)):
        fail(f"{label}: the runs left different files")
    for name in must_have:
        if name not in names:
            fail(f"{label}: {name} is missing")
    for name in names:
        a, b = os.path.join(a_dir, name), os.path.join(b_dir, name)
        if os.path.islink(a) or os.path.islink(b):
            if os.readlink(a) != os.readlink(b):
                fail(f"{label}: {name} links differ")
            if os.path.isfile(a) and os.path.getsize(a) == 0:
                fail(f"{label}: {name} is empty")
        elif not filecmp.cmp(a, b, shallow=False):
            fail(f"{label}: {name} differs")
    log(f"{label}: {len(names)} names, card == CPU: "
        + ", ".join(f"{n} ({os.path.getsize(os.path.join(a_dir, n))} B)"
                    for n in must_have))


def phase_rounds(dev) -> dict:
    """`run_rounds_gaps rounds=2` on the card (the port's CLI) and on the
    CPU, in two directories of the smaller draft."""
    kwz = "k32.w100.z1000"
    r1 = f"target.fa.{kwz}.ntLink.gap_fill.fa"
    r2 = f"target.fa.{kwz}.ntLink.ntLink.gap_fill.fa"
    must = [f"target.fa.{kwz}.ntLink.gap_fill.2rounds.fa", r1, r2,
            f"{r1}.{kwz}.ntLink.scaffolds.gap_fill.fa",
            f"{r1}.{kwz}.verbose_mapping.tsv"]
    for rnd in (r1, r2):
        must += [f"{rnd}.agp", f"{rnd}.verbose_mapping.tsv"]
    with tempfile.TemporaryDirectory(prefix="ntlink_smoke_") as root:
        data = os.path.join(root, "data")
        os.makedirs(data)
        write_dataset(data, label="phase 5", **SMALL)
        inputs = [os.path.join(data, f) for f in ("target.fa", "reads.fa")]
        card = make_dir(root, "card", inputs)
        sketch_cuda.launches = 0
        t0 = time.perf_counter()
        rc = run_in(card, lambda: cli.main(ROUNDS_ARGV))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = sketch_cuda.launches
        per_round = list(pipeline.round_launches)
        if rc != 0:
            fail(f"phase 5: port run_rounds_gaps exited {rc}")
        if len(per_round) != 2 or per_round[0] == 0 or launches == 0:
            fail(f"phase 5: round 1 launched no sketch kernel {per_round}")
        if per_round[1] != 0:
            fail(f"phase 5: round 2 launched {per_round[1]} sketch kernels")
        log(f"phase 5: run_rounds_gaps rounds=2 on the card: {card_s:.1f} s; "
            f"sketch kernel launches by round {per_round}")
        cpu = make_dir(root, "cpu", inputs)
        targets, cfg, rounds = cli.parse(ROUNDS_ARGV)
        t0 = time.perf_counter()
        run_in(cpu, lambda: pipeline.run_rounds(cfg, rounds, gap_fill=True,
                                                device="cpu"))
        cpu_s = time.perf_counter() - t0
        log(f"phase 5: the same on the CPU (plain version): {cpu_s:.1f} s")
        same_tree("phase 5", card, cpu, must)
    return {"launches": launches, "card_s": card_s, "cpu_s": cpu_s}


def phase_probe(dev) -> dict:
    """Phase 1b: the integer peak probe against its plain version on the
    card, bit for bit, at the bench's (256, 1024) elements, then one
    timing of each and the probe's rates by width."""
    rng = np.random.default_rng(SEED + 2)
    x = kernel_bench.probe_input(dev, rng)
    worst = 0
    for width in WIDTHS:
        for iters in PROBE_ITERS:
            out = alu_peak_cuda.alu_peak(x, iters, width)
            ref = alu_peak_ref(x, iters, width)
            err = int(((out.long() & 0xFFFFFFFF) - (ref.long() & 0xFFFFFFFF))
                      .abs().max())
            log(f"phase 1b: width={width} iters={iters}: max_abs_err={err}")
            if err != 0:
                fail(f"alu_peak != plain version at width={width} "
                     f"iters={iters}")
            worst = max(worst, err)
    iters = PROBE_ITERS[-1]
    ms = cuda_ms(lambda: alu_peak_cuda.alu_peak(x, iters, 32))
    plain_ms = cuda_ms(lambda: alu_peak_ref(x, iters, 32))
    log(f"phase 1b: (256, 1024) x {iters} iterations at width 32: kernel "
        f"{ms:.3f} ms, plain version {plain_ms:.3f} ms (median of 10)")
    rates = kernel_bench.alu_peak_rates(dev, rng)
    for width in WIDTHS:
        log(f"phase 1b: width {width}: {rates['gops'][width]:.1f} GOPS by "
            f"source ops, {rates['sass_instr'][width]} SASS instructions "
            f"per iteration = {rates['sass_ginstr'][width]:.1f} G instr/s; "
            f"loop body {rates['sass_ops'][width]}")
    return {"max_abs_err": float(worst), "ms": ms, "plain_ms": plain_ms,
            "gops_by_width": rates["gops"]}


def phase_bench(dev) -> dict:
    """Phase 6: the port's kernel bench, with the probe's count set to 0
    just before and read just after."""
    alu_peak_cuda.launches = 0
    sketch_cuda.launches = 0
    out = kernel_bench.run(dev)
    print(json.dumps(out), flush=True)
    if not (out["sketch_equals_plain_on_card"]
            and out["alu_peak_equals_plain_on_card"]):
        fail("6: the kernel bench found a kernel unequal to its plain "
             "version")
    log(f"phase 6: sketch {out['sketch_cuda_gbase_per_s']:.2f} Gbase/s "
        f"(2048 x 16384), {out['sketch_cuda_chunked_gbase_per_s']:.2f} "
        f"Gbase/s (512 x 65536); int32 peak {out['int32_peak_gops']:.1f} "
        f"GOPS at width {out['int32_best_width']}")
    return {"alu_peak": alu_peak_cuda.launches,
            "sketch_rows": sketch_cuda.launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    kern = phase_kernel(dev)
    probe = phase_probe(dev)
    counts = phase_slice(dev)
    rounds = phase_rounds(dev)
    bench = phase_bench(dev)
    counts["launches_by_path"]["5 run_rounds_gaps"] = rounds["launches"]
    counts["launches_by_path"]["6 kernel bench"] = bench["sketch_rows"]
    log(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [{
        "name": "sketch_rows",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "also_replaces": ALSO_REPLACES,
        **counts,
        **kern,
    }, {
        "name": "alu_peak",
        "route": "cuda",
        "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES,
        "launches": bench["alu_peak"],
        "launches_by_path": {"6 kernel bench": bench["alu_peak"]},
        **probe,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
