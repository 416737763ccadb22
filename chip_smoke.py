"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phase 0 builds the port's six native C modules and its CUDA kernels from
the checkout, all at once, and fails if one is missing. Then it holds each
kernel against its plain PyTorch version. Phase 1: the sketch kernel on the
batches the main path gives it (the mapper's batch of bases at pads 1024 ..
2^21, the contig sketcher's 8 x 2^21, and the bench entry point's 1024 x
16384 with every partial height under it), with rows whose length, last
k-mer and last window fall on, before and after a seam of the kernel's
4096-column segments, then its time beside its byte bound at 512 x 16384
and 8 x 2^21 (CUDA events, median of 10, a 64 MiB write before each launch
so that it finds the L2 cold). Phase 1b: the integer peak probe (the
counterpart of bench.py's Pallas microkernel) at (256, 1024), bit for bit,
then its rates by width. Then it drives the port's CLI on a synthetic
draft at C. elegans scale with N gaps and two contigs past 2^21 bases
(phase 2): 2a, the default `pair` run (t=4, so the contig sketch shares
its stream between the card and four C threads, `TorchHybridSketcher`,
and fails unless the card took at least one contig and launched one kernel
for each batch it dispatched; chaining on the card, per-anchor payload),
held byte for byte against the same stage on the native host path
(backend=numpy t=8: C sketcher, C mapping, C chaining, no torch; phase 5
keeps a whole flow on the CPU through the kernel's plain version); 2b, the
lean run (verbose=False: O(runs) payload) with the contig sketch pinned to
the card alone (backend=jax), which must chunk the long contigs and run an
N batch, held against 2a, the contig TSV too; 2c, the host-chained path
(sensitive=True) on 2,000 reads, card vs CPU. Phase 3: backend=hybrid
t=4 (card and host C path at once), verbose and lean, held against 2a and
2b. Phase 4: repeats=True (hash planes) on 2,000 reads, card vs CPU.
Phase 5: `run_rounds_gaps rounds=2` on a smaller draft cut the same way,
card vs CPU, every file of the run; round 2 must launch no sketch kernel.
Phase 6: the kernel bench
(``python -m ntlink_tpu_torch.kernel_bench``), its JSON on a line of its
own. Phases 7-10 run on the phase-5-sized draft with its reads in two
files, each held byte for byte against a one-process, one-device card run.
Phase 7: two processes on the card, `scaffold gap_fill verbose=True` over
NTLINK_GROUP_DIR, and `pair` over NTLINK_COORDINATOR (gloo, loopback) from
a fresh copy of the package in which nothing is built, so that both ranks
reach the first-use builds at once. Phase 8: the card named twice
(``["cuda:0", "cuda:0"]``): two replicas, default and lean, then
index_sharding=hash idx_shards=2 (a 1 x 2 grid on one device: each batch
one graph replay of the grid's step after its key's first), plain and with
repeats=True on 2,000 reads, each failing unless it replayed graphs and
launched the kernel once per batch and idx rank, and the dryruns of
``ntlink_tpu_torch.graft_entry``. Phase 9:
`scaffold gap_fill v=1` under NTLINK_TORCH_PROFILE: the span names in
order, one Chrome trace per stage, and the `pair/map-reads` trace's device
time by `record_function` range (under the profile the steps run
eagerly), then the device ms per read batch of the same reads through
step graph replays beside the eager steps'. Phase 10: backend=numpy in a process
with no CUDA device visible. Phase 12 (with them, on the same draft): the
launchers as a user starts them, `./ntLink_torch pair` against the
one-process run and `./ntLink_rounds_torch` without a rounds target. Phase
11: the bench entry point (``ntlink_tpu_torch.bench``) at its full size,
30,000 reads of 15 kb over 16 contigs of 250 kb, with NTLINK_TIMING=1: the
device, hybrid and strong host legs' tallies are equal, the mapper's
`wire_stats` count the bytes of the batches that ran, every phase of the
stream's timing split is there and no thread's phases sum past the
stream's wall; its result line and the split are printed with the card's
name and power limit; each leg runs fewer times than the bench's own (2
device runs, 1 interleaved hybrid and host run). Phase 13, human scale:
the JAX package's human preset target (750 contigs of 4 Mb, 3.0 Gbase,
from the generator of ``scripts/stress_scale_torch.py``) sketched through
the `pair` stage's contig path three times, at the default knobs (the
card and four C threads), pinned to the card alone (backend=jax), and at
the default knobs again, each with its wall seconds, the card's share of
the contigs, its launches (one for each card batch) and the peak host RSS
sampled over it, the three TSVs byte-identical; its ~59 M-minimizer index
parsed and built into the load-4 bucket table, the table uploaded and read
back byte for byte, 20,000 of its reads mapped with chaining on the card
and the first 2,000 payloads held against the native host path
(`scale.bounded_run`), and the sketch kernel timed on the sketch's own 8 x
2^21 contig batch; the phase checks the disk and memory first and removes
its ~9 GB of files.
Phase 14 holds on the card what the JAX package's behaviour tests pin,
each case with the sketch kernel's count set to 0 just before it and every
launch matched to a device batch: 14a, Make-style reuse on phase 5's
draft, written again (a second `scaffold` launches nothing and leaves
every mtime, touching the reads maps them again to the same DOT, a contig
sketch killed on the card alone at its second step call (the capture of
its first batch), and one killed at the default knobs at the card's first
batch, leave neither a TSV nor a .tmp); 14b, on a draft whose second round
still joins (`write_rounds_dataset` of tests/torch_port/synthetic.py),
round 1, then round 2 from the lifted mapping (`pipeline.map_reads` made
to raise) against a fresh remap, the DOT, path and FASTA equal and fewer
scaffolds than round 1 left; 14c, the genome of known truth of
``tests/test_synthetic_truth.py`` reassembled in order with its gaps, and
gap-filled, card == CPU; 14d, degenerate inputs (empty reads, reads that
map nowhere, sub-k contigs, all-N contig and read, reads of k, k+1 and
k+w-2, gap_fill with nothing to fill), card == CPU, launches equal to the
CPU run's batches.
The step graphs (``ntlink_tpu_torch/step_graph.py``): on the card every
stream replays one CUDA graph of its step per batch, captured once per
static key at its second batch. Through every phase run in this
process, the first replay of each key of each graph set on a batch after
its capture batch is kept with that batch, and as the phase ends it must
equal the eager step on it, byte for byte (its compare launches not
counted); each flow's log line gives its captures, replays, capture
seconds and first batches run eagerly. Phase 15 then makes each cell of
the grid (the sketch step, the mapping step's four payload kinds and the
hash-sharded step on the card named twice, plain and with hash planes, at
phase 1's pads, with and without N) that no flow replayed so, at the
flows' batch heights: eager on one batch, captured and replayed on the
second, replayed on the third, each equal to the eager step.
Every phase prints its lines ("phase <name>: ...") and, as it ends, its
wall seconds ("seconds of phase <name>: <s>"); the line before the two
JSON lines gives the seconds of every phase. Any failure
exits non-zero before the last line, which is the JSON result. Without a
CUDA device it exits 1.
"""
from __future__ import annotations

import contextlib
import filecmp
import importlib.util
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import types
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ntlink_tpu_torch import (
    bench, cli, graft_entry, kernel_bench, mapping_step, native, pipeline,
    scale, step_graph, tracing,
)
from ntlink_tpu_torch import sketch as sketch_mod
from ntlink_tpu_torch.liftover import liftover_mappings
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.index import ContigIndex
from ntlink_tpu_torch.stream_pipeline import (
    PhaseTimer, batch_rows, copy_back, next_pow2, pack_batch, pinned,
)
from ntlink_tpu_torch.native import build as native_build
from ntlink_tpu_torch.parallel.sharded_index import (
    ShardedDeviceIndex, make_mesh_2d, make_sharded_index_mapping_step,
)
from ntlink_tpu_torch.ops import alu_peak_cuda, build, sketch_cuda, sketch_torch
from ntlink_tpu_torch.ops.alu_peak_torch import WIDTHS, alu_peak_ref
from ntlink_tpu_torch.seqio import stream_fastx
from ntlink_tpu_torch.seqio.fastx import stream_codes, write_fasta
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
# the card's peaks, for the bounds: HBM3 at 3.35 TB/s (data sheet, SXM), and
# the INT32 instruction rate, 64 lanes a clock on each of 132 SMs at the 1.98 GHz
# boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_INSTR_PER_S = 64 * 132 * 1.98e9
# 32-bit integer instructions per base that the sketch needs whatever
# computes it: two rolled 64-bit strands (a split rotation and two 64-bit
# XORs each, ~18), their four seed terms (~6), the canonical add and the
# strand compare (4), an amortised O(1) window argmin with 64-bit compares
# (~17), masks and emit (~5)
SKETCH_INSTR_PER_BASE = 50
NATIVE_MODULES = ("fastx", "chain", "graph", "liftover", "sketch", "tsv")

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
# phase 2b: the lean run with the contig sketch on the card alone
LEAN_CARD_ARGV = LEAN_ARGV + ["backend=jax"]
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
# phases 7-10: the same smaller draft, its reads in two files
REPO = os.path.dirname(os.path.abspath(__file__))
TWO_FILES = ["target=target.fa", "reads=reads1.fa reads2.fa", "k=32",
             "w=100", "z=1000"]
SCAF2_ARGV = ["scaffold", "gap_fill", "verbose=True"] + TWO_FILES
PAIR2_ARGV = ["pair", "pairs_tsv=True"] + TWO_FILES
REPEATS2_ARGV = REPEATS_ARGV + ["index_sharding=hash", "idx_shards=2"]
TWO_CARDS = ["cuda:0", "cuda:0"]
SPANS = ["pair/contig-sketch", "pair/map-reads", "pair/graph-build",
         "layout+stitch", "overlap-trim", "merge", "gap-fill"]
#: the port's spans nested in SPANS, by parent (the hybrid contig sketch
#: adds contig-sketch/card, /host and /tail)
NESTED = {"contig-sketch/render": "pair/contig-sketch",
          "index/read": "pair/contig-sketch",
          "index/parse": "pair/contig-sketch",
          "index/dedup": "pair/contig-sketch",
          "table/build": "pair/map-reads", "table/upload": "pair/map-reads"}
STEP_RANGES = ("mapping_step/unpack", "mapping_step/sketch",
               "mapping_step/select", "mapping_step/join", "chain/accept",
               "mapping_step/compact")
SKETCH_KERNEL = "sketch_rows_kernel"
# phase 11: the bench's full workload, each leg run fewer times than the
# bench's own 4 device runs and 3 interleaved hybrid and host runs
BENCH_RUNS = {"DEVICE_RUNS": 2, "INTERLEAVED_RUNS": 1}
RANK_TIMEOUT_S = 600
# phase 13: the JAX package's human preset target (scripts/stress_scale.py)
# with the bounded run's slice of reads, and the memory it asks to have
# available: its resident set peaks near 15 GiB (the generator's genome
# arrays, the 59 M-entry index, the table build's temporaries and the host
# path's workers)
SCALE_CONTIGS, SCALE_CONTIG_LEN = 750, 4_000_000
SCALE_MEM_BYTES = 20 << 30
# (name, backend, directory of its own or None) of the three contig
# sketches of the target, in order; None is the target's own directory,
# whose TSV the bounded run reuses. The default knobs are auto at t=4
SCALE_SKETCHES = (("default", None, None),
                  ("card alone", "jax", "card_alone"),
                  ("default again", None, "default_again"))
# phase 14: the JAX package's behaviour checks on the card. 14a and 14b run
# on a fresh copy of phase 5's draft; 14c on the genome of
# tests/test_synthetic_truth.py; 14d on hand-made degenerate inputs
SCAF_ARGV = ["scaffold", "target=target.fa", "reads=reads.fa", "k=32",
             "w=100", "z=1000"]
ROUND2_ARGV = ["scaffold", "target=round1.fa", "reads=reads.fa", "k=32",
               "w=100", "z=1000"]
ROUND2_PREFIX = "round1.fa.k32.w100.z1000"
# the contig sketch of the killed stream dies at its second step call:
# on the card that is the capture of its first batch's step graph
KILL_AFTER_STEPS = 1
TRUTH_BASES = np.array(list("ACGT"))
#: wall seconds of each phase of this run, by phase name
PHASE_SECONDS = {}
# phase 15: the step graphs. The grid of keys whose replays must equal the
# eager step: each step's payload kind at phase 1's pads, with and without
# N, at the batch heights of the flows' batches of bases
GRAPH_KINDS = ("sketch", "no chain", "hash planes", "anchors", "runs-only",
               "hash grid", "hash grid, hash planes")
GRAPH_CELLS = [(kind, pad, has_n) for kind in GRAPH_KINDS for pad in PADS
               for has_n in (False, True)]


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def child_processes() -> list:
    """(pid, state, command) of every process whose parent is this one."""
    me, out = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                stat = fh.read()
        except OSError:  # gone between the listing and the read
            continue
        comm = stat[stat.find("(") + 1:stat.rfind(")")]
        state, ppid = stat[stat.rfind(")") + 2:].split()[:2]
        if int(ppid) == me:
            out.append((int(name), state, comm))
    return out


def stop_children() -> list:
    """Ends every process this one started and still has, and waits for
    each. The one that a passing run has is the resource tracker that
    `multiprocessing` starts with the layout sweep's first spawned pool:
    it lives as long as its parent unless it is stopped here, by closing
    its pipe and waiting for it. Returns whatever else had to be killed."""
    from multiprocessing import resource_tracker
    resource_tracker._resource_tracker._stop()
    killed = []
    for pid, state, comm in child_processes():
        if state != "Z":
            killed.append((pid, comm))
            os.kill(pid, signal.SIGKILL)
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:  # already waited for
            pass
    return killed


def edge_specs(L: int, k: int, w: int):
    """(length, fill) of the rows every batch shape must get right: length
    L; where the row spans more than one kernel segment, the nine lengths
    that put the row's end, its last k-mer and its last window on the last
    seam, one column before it and one after; k+w-1 (one window); k+w-2
    (none); k-1 and 0 (no k-mer); then rows whose keys repeat (all-A and
    period-2 at full length, all-A ending one window past the seam), so
    each winner hinges on the leftmost-tie rule across every segment seam.
    fill None means random bases."""
    seg = sketch_cuda.SEGMENT
    lengths = [L]
    ties = [(L, (0,)), (L, (2, 1))]
    if L > seg:
        seam = (L // seg - 1) * seg
        for past in (0, k, k + w - 1):
            lengths += [seam + past + d for d in (-1, 0, 1)]
        ties.append((seam + k + w, (0,)))
    lengths += [k + w - 1, k + w - 2, k - 1, 0]
    return [(min(n, L), None) for n in lengths] + ties


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
    diffs = [
        fwd[valid].int() - r_fwd[valid].int(),
        winner.long() - r_win.long(),
        emit.int() - r_emit.int(),
    ]
    # a batch of one row too short for a k-mer has no valid column
    return max(float(d.abs().max()) for d in diffs if d.numel())


def cuda_ms(fn, reps: int = 10, flush: torch.Tensor = None) -> float:
    """Median milliseconds of `fn` over `reps` runs, CUDA events; `flush`
    (a buffer larger than the L2) is rewritten before each run, so that
    `fn` finds its inputs in device memory, not in the cache."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
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
    # one nvcc per CUDA source and one cc per native module, all started
    # together
    def timed_native(name: str):
        t0 = time.perf_counter()
        mod = getattr(native, f"{name}_module")()
        return name, mod, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        kernels = pool.map(build.build, ("sketch", "alu_peak"))
        natives = list(pool.map(timed_native, NATIVE_MODULES))
        list(kernels)
    log(f"phase 0: nvcc builds of {KERNEL_SOURCE}: "
        f"{build.build_seconds['sketch']:.2f} s, of {PROBE_SOURCE}: "
        f"{build.build_seconds['alu_peak']:.2f} s compile; cc builds of "
        f"ntlink_tpu_torch/native: "
        + ", ".join(f"{name} {secs:.2f} s" for name, _, secs in natives)
        + f" ({time.perf_counter() - t0:.2f} s wall for all)")
    for name, mod, _ in natives:
        if mod is None:
            try:
                native_build.load(f"ntlink_{name}")
            except Exception as exc:
                fail(f"phase 0: native module {name} did not build: {exc}")
            fail(f"phase 0: native module {name} is missing")
        if not mod.__file__.startswith(os.path.dirname(native.__file__)):
            fail(f"phase 0: native module {name} loaded from {mod.__file__}")
    return smi


def batch_shapes(batch_bases: int):
    """(B, pad) of every batch the main path gives the kernel: the mapper's
    heights at each pad, and the contig sketcher's at 2^21."""
    shapes = [(batch_rows(L, batch_bases), L) for L in PADS]
    shapes.append((batch_rows(CONTIG_PAD, TorchSketcher("cpu").batch_bases),
                   CONTIG_PAD))
    return shapes


def bench_shapes():
    """(B, pad) of every batch the bench entry point can give the kernel.
    Its reads all pad to one length; its device leg sends full batches of
    `bench.BATCH_BASES` bases and its warm-up one partial batch, and its
    hybrid leg ends the device's stream wherever the scheduler finds it
    idle, so a partial batch there may have any power-of-two height."""
    pad = next_pow2(bench.READ_LEN)
    full = batch_rows(pad, bench.BATCH_BASES)
    return [(B, pad) for B in (1 << e for e in range(full.bit_length()))]


def sketch_bound_ms(B: int, L: int, k: int, w: int):
    """(least milliseconds the card could take for one sketch of a (B, L)
    batch, "bytes" or "operations"): codes and lengths read once and the
    four planes written once at the memory rate, against the integer
    instructions the function needs at the INT32 instruction rate."""
    nw = max(L - k - w + 2, 0)
    by_bytes = (B * L * (1 + 8 + 1) + B * nw * (4 + 1) + 4 * B) \
        / HBM_BYTES_PER_S
    by_ops = B * L * SKETCH_INSTR_PER_BASE / INT32_INSTR_PER_S
    return 1e3 * max(by_bytes, by_ops), \
        "bytes" if by_bytes >= by_ops else "operations"


def phase_kernel(dev) -> dict:
    """Kernel vs plain version at the batch shapes of the main paths: the
    `pair` runs' and the bench entry point's."""
    batch_bases = cli.parse(PAIR_ARGV)[1].batch_bases
    shapes = batch_shapes(batch_bases)
    shapes += [s for s in bench_shapes() if s not in shapes]
    rng = np.random.default_rng(SEED)
    worst = 0.0
    times = {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for k, w in KW_GRID:
        for B, L in shapes:
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
                        lambda: sketch_cuda.sketch_rows(codes, lengths, k, w),
                        flush=flush,
                    )
                    plain_ms = cuda_ms(lambda: sketch_torch.sketch_rows_ref(
                        codes, lengths, k, w
                    ), flush=flush)
                    bound_ms, bound_by = sketch_bound_ms(B, L, k, w)
                    times[(B, L)] = (ms, plain_ms, bound_ms, bound_by)
                    log(f"phase 1: B={B} x pad={L} (k={k} w={w}): kernel "
                        f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                        f"share of bound {bound_ms / ms:.3f}; plain version "
                        f"{plain_ms:.3f} ms (median of 10, L2 flushed "
                        f"before each launch; "
                        f"{sketch_cuda.blocks_per_sm(L, k, w)} blocks per SM)")
    (ms, plain_ms, bound_ms, bound_by), (c_ms, c_plain_ms, c_bound_ms, _) = (
        times[c[2:]] for c in TIME_CASES)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "library_ms": None,
            "contig_batch_ms": c_ms, "contig_batch_plain_ms": c_plain_ms,
            "contig_batch_bound_ms": c_bound_ms,
            "contig_batch_share_of_bound": c_bound_ms / c_ms}


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


def graph_kind(static: dict) -> str:
    """The payload kind of a step call, from its static arguments."""
    if "grid" in static:  # a device's step of the hash-sharded grid
        if static["finish"] == "rows":
            return "hash join"
        return "hash grid" + (", hash planes" if static["with_hashes"]
                              else "")
    if "max_mins" in static:
        return "sketch"
    if static["runs"]:
        return "runs-only"
    if static["with_hashes"]:
        return "hash planes"
    return "no chain" if static["clen"] is None else "anchors"


class GraphCheck:
    """Every step graph key's first replay on a batch other than the one it
    was captured on, in this process, against the eager step. While
    installed, `StepGraphs.run` keeps, at that replay of each key of each
    graph set, the batch and a host copy of the replayed payload (copied
    on the replay's stream; a batch input on the card, as the hash grid's
    first device takes from the others, is copied too); `verify`, called
    as each phase ends, runs the eager step on that batch on the card and
    compares the bytes. Its launches are compare launches: the kernel's
    count is put back after them."""

    def __init__(self):
        self.pending = []
        #: (kind, pad, has N) -> keys held, over every phase so far
        self.cells = {}
        self._seen = weakref.WeakKeyDictionary()
        self._real = None

    def install(self) -> None:
        real = self._real = step_graph.StepGraphs.run
        check = self

        def run(graphs, step, batch, static):
            replays, captures = graphs.replays, graphs.captures
            out = real(graphs, step, batch, static)
            if graphs.replays > replays and graphs.captures == captures:
                seen = check._seen.setdefault(graphs, set())
                key = graphs.key(step, batch, static)
                if key not in seen:
                    seen.add(key)
                    held = {n: None if t is None else t.to("cpu", copy=True)
                            for n, t in batch.items()}
                    check.pending.append((graphs.device, step, held, static,
                                          out.to("cpu", copy=True)))
            return out

        step_graph.StepGraphs.run = run

    def uninstall(self) -> None:
        step_graph.StepGraphs.run = self._real

    def verify(self, label: str) -> None:
        if not self.pending:
            return
        launches = sketch_cuda.launches
        for dev, step, batch, static, replayed in self.pending:
            inputs = {n: None if t is None else t.to(dev)
                      for n, t in batch.items()}
            eager = step(**inputs, **static).cpu()
            cell = (graph_kind(static), static["L"],
                    batch["nmask"] is not None)
            if not torch.equal(eager, replayed):
                fail(f"phase {label}: the replay of a {cell} step graph "
                     f"differs from the eager step")
            self.cells[cell] = self.cells.get(cell, 0) + 1
        sketch_cuda.launches = launches
        log(f"phase {label}: {len(self.pending)} step graph keys, each "
            f"one's first replay after its capture batch equal to the "
            f"eager step byte for byte")
        self.pending.clear()


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
        f"{mapper.host_fallbacks} host-fallback reads; wire_stats "
        f"{mapper.wire_stats}; read mapping "
        f"{step_graph.summary(mapper.graph_counts())}"
        + (f", contig sketch "
           f"{step_graph.summary(step_graph.counts([card_sk.graphs]))}"
           if card_sk else ""))
    if card_sk is not None:
        log(f"{label}: contig sketch on the card: "
            f"{card_sk.stream_seconds:.3f} s; {card_sk.device_rows} device "
            f"rows, {card_sk.chunked} chunked contigs, batches by (pad, has "
            f"N) {card_sk.batches_by_pad}; {card_sk.host_fallbacks} "
            f"host-fallback rows")
    return mapper, sketcher, launches, secs


def hybrid_contig_split(sketcher, n_contigs: int, label: str) -> dict:
    """The default run's contig sketch: it must have gone through the
    hybrid, the card must have taken at least one contig, and the card
    path must have launched one sketch kernel per batch it dispatched.
    Logs and returns the split."""
    if not isinstance(sketcher, TorchHybridSketcher):
        fail(f"{label}: the contig sketch ran on {type(sketcher).__name__}, "
             f"not the hybrid of the default knobs")
    n = sketcher.device_seqs + sketcher.host_seqs
    batches = sum(sketcher.batches_by_pad.values())
    if n != n_contigs or sketcher.device_seqs < 1:
        fail(f"{label}: the card took {sketcher.device_seqs} and the host "
             f"{sketcher.host_seqs} of {n_contigs} contigs")
    if sketcher.kernel_launches != batches:
        fail(f"{label}: the contig sketch launched "
             f"{sketcher.kernel_launches} kernels for {batches} card batches")
    split = {"device_seqs": sketcher.device_seqs,
             "host_seqs": sketcher.host_seqs,
             "device_bases": sketcher.device_bases,
             "host_bases": sketcher.host_bases,
             "device_share": sketcher.device_seqs / n,
             "seconds": sketcher.stream_seconds,
             "card_path_seconds": sketcher.device_backend.stream_seconds,
             "launches": sketcher.kernel_launches}
    log(f"{label}: contig sketch (card + {sketcher.threads} C threads): "
        f"{sketcher.stream_seconds:.3f} s; card {sketcher.device_seqs} "
        f"contigs ({100 * split['device_share']:.1f}%), "
        f"{sketcher.device_bases} bases, in {batches} batches "
        f"({sketcher.kernel_launches} launches; the card path's streams "
        f"{split['card_path_seconds']:.3f} s); host {sketcher.host_seqs} "
        f"contigs, {sketcher.host_bases} bases")
    return split


def host_pair(d: str, argv, label: str) -> None:
    """The same stage on the native host path (backend=numpy t=8): the C
    sketcher, C mapping and C chaining, no device and no torch kernel."""
    t0 = time.perf_counter()
    cfg = cli.parse(argv + ["backend=numpy", "t=8"])[1]
    run_in(d, lambda: pipeline.pair_stage(cfg))
    log(f"{label}: the same stage on the native host path (backend=numpy "
        f"t=8): {time.perf_counter() - t0:.1f} s")


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

        # 2a, the main path: the default run (verbose, prechained; t=4, so
        # the contig sketch shares its stream between the card and four C
        # threads) on the card, then the same stage on the native host path
        # (backend=numpy), which shares no code with the card's
        card = make_dir(root, "card", inputs)
        torch.cuda.reset_peak_memory_stats(dev)
        with clock("2a"):
            mapper, sketcher, launches, _ = card_pair(card, PAIR_ARGV, dev,
                                                      "phase 2a")
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"phase 2a: peak device memory {peak / 2**20:.1f} MiB")
        if mapper.device_reads + mapper.host_fallbacks != n_reads:
            fail(f"2a mapped {mapper.device_reads + mapper.host_fallbacks} "
                 f"reads, expected {n_reads}")
        if not mapper.prechained or mapper.runs_only:
            fail("2a: the default run is not prechained per-anchor")
        split = hybrid_contig_split(sketcher, N_CONTIGS + N_LONG, "phase 2a")
        if launches != batches_of(sketcher, mapper):
            fail(f"2a: {launches} sketch kernel launches for "
                 f"{batches_of(sketcher, mapper)} device batches")
        if not any(has_n for _, has_n in mapper.batches_by_pad):
            fail("2a: no read N batch ran on the card")
        # every input is at least k long but the sub-k reads, so those are
        # the only exact-host rows either stream may have
        if sketcher.host_fallbacks != 0 or mapper.host_fallbacks != N_SUBK:
            fail(f"2a: host fallbacks: {sketcher.host_fallbacks} contig "
                 f"rows, {mapper.host_fallbacks} reads (sub-k: {N_SUBK})")
        if max(L for L, _ in mapper.batches_by_pad) <= 16384:
            fail("2a: no read batch in the pad > 16384 domain")
        host = make_dir(root, "host", inputs)
        with clock("2a reference"):
            host_pair(host, PAIR_ARGV, "phase 2a")
        same_bytes("phase 2a", card, host,
                   [PREFIX + a for a in ARTIFACTS] + [CONTIG_TSV])
        with open(os.path.join(card, PREFIX + ARTIFACTS[0])) as fh:
            edges = sum(" -> " in line for line in fh)
        if edges == 0:
            fail("scaffold graph has no edges")
        log(f"phase 2a: scaffold graph edges: {edges}")
        by_path = {"2a contig sketch": sketcher.kernel_launches,
                   "2a read mapping": mapper.kernel_launches}

        # 2b: the lean run (verbose=False: runs-only payload) in a fresh
        # directory, its contig sketch pinned to the card alone
        # (backend=jax: the same read mapping as auto); its artifacts, the
        # contig TSV too, must be 2a's
        lean = make_dir(root, "lean", inputs)
        with clock("2b"):
            mapper_b, sketcher_b, _, _ = card_pair(lean, LEAN_CARD_ARGV, dev,
                                                   "phase 2b")
        if not mapper_b.runs_only:
            fail("2b: the lean run did not ship runs-only payloads")
        if not isinstance(sketcher_b, TorchSketcher) \
                or sketcher_b.chunked != N_LONG:
            fail("2b: the card-alone contig sketch did not chunk the long "
                 "contigs")
        if not any(has_n for _, has_n in sketcher_b.batches_by_pad):
            fail("2b: no contig N batch ran on the card")
        if sketcher_b.host_fallbacks != 0 or sketcher_b.kernel_launches \
                != sum(sketcher_b.batches_by_pad.values()):
            fail(f"2b: {sketcher_b.host_fallbacks} host-fallback contig "
                 f"rows, {sketcher_b.kernel_launches} launches for "
                 f"{sketcher_b.batches_by_pad}")
        log(f"phase 2b: contig sketch of {N_CONTIGS + N_LONG} contigs: card "
            f"alone {sketcher_b.stream_seconds:.3f} s; 2a's default "
            f"(card + {sketcher.threads} C threads) "
            f"{sketcher.stream_seconds:.3f} s, the card taking "
            f"{100 * split['device_share']:.1f}% of the contigs")
        same_bytes("phase 2b", card, lean,
                   [PREFIX + a for a in ARTIFACTS[:2]] + [CONTIG_TSV])
        by_path["2b contig sketch"] = sketcher_b.kernel_launches
        by_path["2b read mapping"] = mapper_b.kernel_launches

        # 2c: the host-chained per-anchor path (sensitive=True) on the
        # first 2,000 reads, card vs CPU, on 2a's contig sketch
        links = [inputs[0], os.path.join(data, "reads2k.fa"),
                 os.path.join(card, CONTIG_TSV)]
        sens_card = make_dir(root, "sens_card", links)
        with clock("2c"):
            mapper_c, _, _, _ = card_pair(sens_card, SENS_ARGV, dev,
                                          "phase 2c")
        if mapper_c.prechained:
            fail("2c: sensitive=True must chain on the host")
        sens_cpu = make_dir(root, "sens_cpu", links)
        with clock("2c reference"):
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
            with clock(f"3 {name}"):
                mapper_h, sketcher_h, _, secs = card_pair(d, argv, dev,
                                                          label)
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
        with clock("4"):
            mapper_r, _, _, _ = card_pair(rep_card, REPEATS_ARGV, dev,
                                          "phase 4")
        if not mapper_r.with_hashes or mapper_r.prechained:
            fail("4: repeats=True must ship hash planes and chain on the "
                 "host")
        rep_cpu = make_dir(root, "rep_cpu", links)
        with clock("4 reference"):
            cpu_pair(rep_cpu, REPEATS_ARGV, "phase 4")
        same_bytes("phase 4", rep_card, rep_cpu,
                   [PREFIX + a for a in ARTIFACTS])
        by_path["4 repeats"] = mapper_r.kernel_launches
    return {"launches": launches, "launches_by_path": by_path,
            "hybrid": hybrid}


def same_tree(label: str, a_dir: str, b_dir: str, must_have,
              what: str = "card == CPU") -> None:
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
    log(f"{label}: {len(names)} names, {what}: "
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


def split_read_files(d: str) -> None:
    """reads1.fa and reads2.fa: the two halves of `d`/reads.fa, so that
    file sharding has something to split."""
    with open(os.path.join(d, "reads.fa"), "rb") as fh:
        lines = fh.read().splitlines(keepends=True)
    half = (len(lines) // 4) * 2
    for name, part in (("reads1.fa", lines[:half]), ("reads2.fa",
                                                     lines[half:])):
        with open(os.path.join(d, name), "wb") as fh:
            fh.writelines(part)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(root: str, name: str, argv, inputs, group_env: dict,
              pythonpath: str):
    """Two ranks of ``python -m ntlink_tpu_torch`` at once, each in a
    directory of its own. Returns ([directory], [sketch kernel launches the
    rank reported], all exit codes 0). Each rank leads a process group of
    its own; both are waited for, killed at RANK_TIMEOUT_S, and whatever
    they started and left behind dies with their group."""
    dirs, procs, logs = [], [], []
    for pid in range(2):
        d = os.path.join(root, f"{name}_rank{pid}")
        if os.path.exists(d):
            shutil.rmtree(d)
        make_dir(root, f"{name}_rank{pid}", inputs)
        dirs.append(d)
        logs.append(os.path.join(root, f"{name}_rank{pid}.log"))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("NTLINK_")}
        env.update(group_env, PYTHONPATH=pythonpath,
                   NTLINK_NUM_PROCESSES="2", NTLINK_PROCESS_ID=str(pid))
        with open(logs[-1], "wb") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ntlink_tpu_torch", *argv], cwd=d,
                env=env, stdout=fh, stderr=subprocess.STDOUT,
                process_group=0,
            ))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:  # the group ended with its leader
            pass
    launches, ok = [], True
    for pid, (p, path) in enumerate(zip(procs, logs)):
        with open(path, errors="replace") as fh:
            text = fh.read()
        if p.returncode != 0:
            ok = False
            log(f"{name}: rank {pid} exited {p.returncode}:\n{text[-3000:]}")
        launches.append(sum(
            int(n) for n in re.findall(r"(\d+) sketch kernel launch", text)))
    return dirs, launches, ok


def phase_ranks(root: str, inputs, one_scaffold: str, one_pair: str,
                must_scaffold) -> dict:
    """Phase 7: two processes on the card."""
    by_path = {}
    # 7a: scaffold gap_fill over the shared-directory transport, the built
    # package of this checkout
    t0 = time.perf_counter()
    dirs, launches, ok = run_ranks(
        root, "p7a", SCAF2_ARGV, inputs,
        {"NTLINK_GROUP_DIR": os.path.join(root, "group")}, REPO)
    if not ok:
        fail("phase 7a: a rank failed")
    log(f"phase 7a: scaffold gap_fill as two ranks over NTLINK_GROUP_DIR: "
        f"{time.perf_counter() - t0:.1f} s; sketch kernel launches by rank "
        f"{launches}")
    for pid, d in enumerate(dirs):
        if launches[pid] == 0:
            fail(f"phase 7a: rank {pid} launched no sketch kernel")
        same_tree(f"phase 7a rank {pid}", one_scaffold, d, must_scaffold,
                  what="one process == this rank")
        by_path[f"7a rank {pid} (group dir)"] = launches[pid]
    # 7b: pair over the coordinator transport (gloo), from a copy of the
    # package in which nothing is built: both ranks reach the first-use
    # builds of the kernel and the C modules at once
    fresh = os.path.join(root, "fresh")
    shutil.copytree(
        os.path.join(REPO, "ntlink_tpu_torch"),
        os.path.join(fresh, "ntlink_tpu_torch"),
        ignore=shutil.ignore_patterns("_build", "*.so", "__pycache__"),
    )
    t0 = time.perf_counter()
    for attempt in range(2):  # the free port can be taken before the bind
        dirs, launches, ok = run_ranks(
            root, "p7b", PAIR2_ARGV, inputs,
            {"NTLINK_COORDINATOR": f"127.0.0.1:{free_port()}"}, fresh)
        if ok:
            break
        if attempt:
            fail("phase 7b: a rank failed twice")
    built = sorted(os.listdir(os.path.join(fresh, "ntlink_tpu_torch",
                                           "_build")))
    natives = [f for f in os.listdir(
        os.path.join(fresh, "ntlink_tpu_torch", "native"))
        if f.endswith(".so")]
    if len(built) != 1 or any(".tmp" in f for f in built) \
            or len(natives) < 4 or any(f.startswith(".") for f in natives):
        fail(f"phase 7b: the concurrent first-use builds left {built} and "
             f"{natives}")
    log(f"phase 7b: pair as two ranks over NTLINK_COORDINATOR (gloo), "
        f"nothing built beforehand: {time.perf_counter() - t0:.1f} s; both "
        f"ranks built {built} and {len(natives)} C modules; sketch kernel "
        f"launches by rank {launches}")
    pair_names = [PREFIX + a for a in ARTIFACTS] + [CONTIG_TSV]
    for pid, d in enumerate(dirs):
        if launches[pid] == 0:
            fail(f"phase 7b: rank {pid} launched no sketch kernel")
        same_tree(f"phase 7b rank {pid}", one_pair, d, pair_names,
                  what="one process == this rank")
        by_path[f"7b rank {pid} (gloo)"] = launches[pid]
    return by_path


def hash_grid_graphs(mapper, launches: int, label: str) -> str:
    """A hash-sharded run on the card named twice (a 1 x 2 grid on one
    device) must have replayed its grid's step graphs, one step a batch
    (the first of each key eager, every other a replay), and launched the
    sketch kernel once per batch and idx rank. Returns the graphs'
    summary."""
    counts = mapper.graph_counts()
    batches = sum(mapper.batches_by_pad.values())
    summary = step_graph.summary(counts)
    if counts is None or counts[1] == 0:
        fail(f"{label}: the hash grid replayed no step graph ({summary})")
    if counts[1] + counts[3] != batches:
        fail(f"{label}: {counts[1]} replays and {counts[3]} first batches "
             f"eager for {batches} batches")
    if launches != batches * mapper.idx_shards:
        fail(f"{label}: {launches} sketch launches for {batches} batches "
             f"x {mapper.idx_shards} idx ranks")
    return summary


def phase_replicas(dev, root: str, data: str, one_pair: str) -> dict:
    """Phase 8: the card named twice. Every run maps on the contig sketch
    of the one-process run; the first, on the card named once, gives the
    peak device memory that the others are read beside."""
    by_path = {}
    one_peak = 0
    links = [os.path.join(data, f) for f in
             ("target.fa", "reads1.fa", "reads2.fa", "reads2k.fa")]
    links.append(os.path.join(one_pair, CONTIG_TSV))
    runs = (
        ("one device", PAIR2_ARGV, ARTIFACTS, "replicated", TWO_CARDS[:1]),
        ("two replicas", PAIR2_ARGV, ARTIFACTS, "replicated", TWO_CARDS),
        ("two replicas, lean", PAIR2_ARGV + ["verbose=False"], ARTIFACTS[:2],
         "replicated", TWO_CARDS),
        ("hash idx_shards=2", PAIR2_ARGV + ["index_sharding=hash",
                                            "idx_shards=2"], ARTIFACTS,
         "hash", TWO_CARDS),
    )
    for i, (name, argv, arts, layout, cards) in enumerate(runs):
        d = make_dir(root, f"p8_{i}", links)
        sketch_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        cfg = cli.parse(argv)[1]
        run_in(d, lambda: pipeline.pair_stage(cfg, device=cards))
        torch.cuda.synchronize()
        mapper = pipeline.last_mapper
        peak = torch.cuda.max_memory_allocated(dev)
        one_peak = one_peak or peak
        n = mapper.device_reads + mapper.host_fallbacks
        if mapper.n_devices != len(cards) or mapper.index_sharding != layout:
            fail(f"phase 8 ({name}): ran {mapper.layout()}")
        per_dev = mapper.launches_by_device()
        if sketch_cuda.launches == 0 or min(per_dev) == 0:
            fail(f"phase 8 ({name}): launches {per_dev}")
        graphs = step_graph.summary(mapper.graph_counts())
        if layout == "hash":
            graphs = hash_grid_graphs(mapper, sketch_cuda.launches,
                                      f"phase 8 ({name})")
        log(f"phase 8 ({name}): {mapper.layout()}; {n} reads in "
            f"{mapper.stream_seconds:.3f} s = "
            f"{n / mapper.stream_seconds:.1f} reads/s (one card shared, not "
            f"a scaling number; prechained={mapper.prechained}, "
            f"runs_only={mapper.runs_only}); sketch kernel launches "
            f"{sketch_cuda.launches}, by replica {per_dev}; peak device "
            f"memory of the mapping {peak / 2**20:.1f} MiB (one device: "
            f"{one_peak / 2**20:.1f} MiB); {graphs}")
        same_bytes(f"phase 8 ({name})", one_pair, d,
                   [PREFIX + a for a in arts])
        by_path[f"8 {name}"] = sketch_cuda.launches
    # hash-sharded with repeats=True (hash planes through the sharded join)
    # on 2,000 reads, against one device
    rep_one = make_dir(root, "p8_rep_one", links)
    run_in(rep_one, lambda: pipeline.pair_stage(
        cli.parse(REPEATS_ARGV)[1], device=dev))
    rep_hash = make_dir(root, "p8_rep_hash", links)
    sketch_cuda.launches = 0
    run_in(rep_hash, lambda: pipeline.pair_stage(
        cli.parse(REPEATS2_ARGV)[1], device=TWO_CARDS))
    mapper = pipeline.last_mapper
    if mapper.index_sharding != "hash" or not mapper.with_hashes \
            or sketch_cuda.launches == 0:
        fail(f"phase 8 (hash, repeats): ran {mapper.layout()}")
    graphs = hash_grid_graphs(mapper, sketch_cuda.launches,
                              "phase 8 (hash, repeats)")
    log(f"phase 8 (hash, repeats): {mapper.layout()}; "
        f"{sketch_cuda.launches} sketch kernel launches; {graphs}")
    same_bytes("phase 8 (hash, repeats)", rep_one, rep_hash,
               [PREFIX + a for a in ARTIFACTS])
    by_path["8 hash, repeats"] = sketch_cuda.launches
    sketch_cuda.launches = 0
    graft_entry.dryrun_multichip(2, devices=TWO_CARDS)
    fn, args = graft_entry.entry(dev)
    out = fn(*args)
    torch.cuda.synchronize()
    if sketch_cuda.launches == 0 or int(out[:8].sum()) == 0:
        fail("phase 8: the dryruns launched no kernel or found no anchor")
    log(f"phase 8: graft_entry.dryrun_multichip(2) and entry() on "
        f"{TWO_CARDS}: passed, {sketch_cuda.launches} sketch kernel launches")
    by_path["8 dryruns"] = sketch_cuda.launches
    return by_path


def phase_tracing(dev, root: str, inputs, one_scaffold: str,
                  must) -> dict:
    """Phase 9: v=1 with the profile hook."""
    d = make_dir(root, "p9", inputs)
    prof_dir = os.path.join(root, "prof")
    tracer = tracing.GLOBAL
    tracer.torch_profile_dir = prof_dir
    sketch_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        rc = run_in(d, lambda: cli.main(SCAF2_ARGV + ["v=1"]))
    finally:
        tracer.enabled = False
        tracer.torch_profile_dir = None
    torch.cuda.synchronize()
    if rc != 0:
        fail(f"phase 9: scaffold gap_fill v=1 exited {rc}")
    walls = {s.name: s.wall_s for s in tracer.spans}
    tracer.spans.clear()
    log(f"phase 9: scaffold gap_fill v=1 under NTLINK_TORCH_PROFILE: "
        f"{time.perf_counter() - t0:.1f} s")
    trace_json = os.path.join(d, PREFIX + ".trace.json")
    with open(trace_json) as fh:
        spans = json.load(fh)
    names = [s["name"] for s in spans if s["parent"] is None]
    if names != SPANS:
        fail(f"phase 9: top-level spans {names}")
    nested = {s["name"]: s["parent"] for s in spans if s["parent"]}
    paths = {n: "pair/contig-sketch" for n in nested
             if n in ("contig-sketch/card", "contig-sketch/host",
                      "contig-sketch/tail")}
    if nested != {**NESTED, **paths}:
        fail(f"phase 9: nested spans {nested}")
    os.remove(trace_json)
    same_tree("phase 9", one_scaffold, d, must, what="without v == with v=1")
    for span in SPANS:
        path = os.path.join(prof_dir, span, "trace.json")
        if not (os.path.exists(path) and os.path.getsize(path) > 0):
            fail(f"phase 9: no Chrome trace for {span}")
    split = tracing.stage_device_times(
        os.path.join(prof_dir, "pair/map-reads", "trace.json"))
    missing = [r for r in STEP_RANGES
               if split["stages"].get(r, {}).get("us", 0) <= 0]
    if missing:
        fail(f"phase 9: no device time under {missing}")
    kernel_us = sum(us for name, us in split["kernels"].items()
                    if SKETCH_KERNEL in name)
    if kernel_us <= 0:
        fail(f"phase 9: the map-reads trace does not hold {SKETCH_KERNEL}")
    total = split["total_us"]
    wall = walls["pair/map-reads"]
    log(f"phase 9: {len(SPANS)} spans in order, one trace each, and "
        f"{len(nested)} nested in them; "
        f"pair/map-reads (default run, profiler on): device time "
        f"{total / 1e3:.3f} ms = {total / 1e6 / wall:.2%} of its "
        f"{wall:.3f} s wall; {SKETCH_KERNEL} {kernel_us / 1e3:.3f} ms")
    for name, row in sorted(split["stages"].items(),
                            key=lambda kv: -kv[1]["us"]):
        log(f"phase 9:   {name:<24} {row['us'] / 1e3:9.3f} ms "
            f"{row['us'] / total:7.2%} ({row['events']} kernels and copies)")
    log(f"phase 9:   {'(outside every range)':<24} "
        f"{split['unattributed_us'] / 1e3:9.3f} ms "
        f"{split['unattributed_us'] / total:7.2%}")
    launches = sketch_cuda.launches
    eager_batches = sum(pipeline.last_mapper.batches_by_pad.values())
    replay_ms, replays = replay_device_ms(dev, root, d)
    log(f"phase 9: device ms per read batch: eager steps (the profiled "
        f"flow, {eager_batches} batches) {total / 1e3 / eager_batches:.3f}, "
        f"graph replays (the same reads again with a mapper of its own, "
        f"keys captured in a first pass, {replays} replays profiled) "
        f"{replay_ms:.3f}")
    return {"9 scaffold gap_fill v=1": launches}


def replay_device_ms(dev, root: str, d: str):
    """The pair stage's reads of `d` through a mapper of the same kind with
    its step graphs: once to capture every key, then once more under
    ``torch.profiler`` (a tracer of its own, so the steps stay graphs).
    Returns (device ms per batch of the second pass, its replays)."""
    cfg = cli.parse(SCAF2_ARGV)[1]
    index = ContigIndex.from_tsv(os.path.join(d, CONTIG_TSV))
    lengths = pipeline.read_scaffold_lengths(os.path.join(d, "target.fa"))
    mapper = pipeline.make_mapper(cfg, index, lengths, [dev])

    def run():
        run_in(d, lambda: pipeline.map_reads(cfg, index, lengths, None, None,
                                             mapper))
        torch.cuda.synchronize(dev)

    run()
    replays0 = mapper.graph_counts()[1]
    tracer = tracing.Tracer(enabled=True,
                            torch_profile_dir=os.path.join(root, "prof_g"))
    with tracer.stage("replays"):
        run()
    replays = mapper.graph_counts()[1]
    split = tracing.stage_device_times(
        os.path.join(root, "prof_g", "replays", "trace.json"))
    return split["total_us"] / 1e3 / (replays - replays0), replays - replays0


def phase_numpy(root: str, inputs, one_pair: str) -> None:
    """Phase 10: backend=numpy with no CUDA device visible."""
    d = make_dir(root, "p10", inputs)
    env = {k: v for k, v in os.environ.items() if not k.startswith("NTLINK_")}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "ntlink_tpu_torch", *PAIR2_ARGV,
         "backend=numpy", "t=8"],
        cwd=d, env=env, capture_output=True, text=True,
        timeout=RANK_TIMEOUT_S,
    )
    if res.returncode != 0:
        fail(f"phase 10: backend=numpy exited {res.returncode}:\n"
             f"{res.stderr[-3000:]}")
    if "sketch kernel launch" in res.stderr or \
            "device=none" not in res.stdout:
        fail("phase 10: backend=numpy reached for a device")
    log(f"phase 10: pair backend=numpy t=8, no CUDA device visible: "
        f"{time.perf_counter() - t0:.1f} s")
    same_tree("phase 10", one_pair, d,
              [PREFIX + a for a in ARTIFACTS] + [CONTIG_TSV],
              what="card == host")


def phase_launchers(root: str, inputs, one_pair: str) -> dict:
    """Phase 12: the launchers at the root of the checkout, started as a
    user starts them (their own interpreter line, this interpreter's
    directory first on PATH)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("NTLINK_")}
    env["PATH"] = os.path.dirname(sys.executable) + os.pathsep + env["PATH"]
    d = make_dir(root, "p12", inputs)
    t0 = time.perf_counter()
    res = subprocess.run(
        [os.path.join(REPO, "ntLink_torch"), *PAIR2_ARGV], cwd=d, env=env,
        capture_output=True, text=True, timeout=RANK_TIMEOUT_S,
    )
    if res.returncode != 0:
        fail(f"phase 12: ./ntLink_torch pair exited {res.returncode}:\n"
             f"{res.stderr[-3000:]}")
    launches = sum(int(n) for n in re.findall(
        r"(\d+) sketch kernel launch", res.stderr))
    if launches == 0:
        fail("phase 12: ./ntLink_torch pair launched no sketch kernel")
    log(f"phase 12: ./ntLink_torch pair as a process of its own: "
        f"{time.perf_counter() - t0:.1f} s; {launches} sketch kernel "
        f"launches")
    same_tree("phase 12", one_pair, d,
              [PREFIX + a for a in ARTIFACTS] + [CONTIG_TSV],
              what="one process == ./ntLink_torch")
    d = make_dir(root, "p12_rounds", inputs)
    res = subprocess.run(
        [os.path.join(REPO, "ntLink_rounds_torch"), *PAIR2_ARGV], cwd=d,
        env=env, capture_output=True, text=True, timeout=RANK_TIMEOUT_S,
    )
    if res.returncode != 0 or res.stdout.strip() != cli.HELP.strip() \
            or len(os.listdir(d)) != len(inputs):
        fail(f"phase 12: ./ntLink_rounds_torch without a rounds target: "
             f"exit {res.returncode}, {len(res.stdout)} bytes of output, "
             f"files {sorted(os.listdir(d))}\n{res.stderr[-2000:]}")
    log("phase 12: ./ntLink_rounds_torch without a rounds target: the help "
        "text, exit 0, nothing written")
    return {"12 ./ntLink_torch pair": launches}


def stream_batches(n_reads: int, pad: int, batch_bases: int) -> list:
    """Heights of the batches that a stream of `n_reads` reads of one
    padded length sends to one device: a bucket flushes when it holds a
    full batch, every bucket flushes when the reads since the last such
    flush pad to four batches of bases and at the stream's end, and a
    partial batch's height is the next power of two."""
    B = batch_rows(pad, batch_bases)
    heights = []
    held = budget = 0
    for _ in range(n_reads):
        held += 1
        budget += pad
        if held == B or (budget >= 4 * batch_bases):
            heights.append(min(B, next_pow2(held)))
            held = 0
        if budget >= 4 * batch_bases:
            budget = 0
    if held:
        heights.append(min(B, next_pow2(held)))
    return heights


def phase_bench_entry(dev, smi: str) -> dict:
    """Phase 11: the bench entry point at its full size, with the stream's
    timing on; both kernels' counts are set to 0 just before and read just
    after."""
    children = child_processes()
    had = os.environ.get("NTLINK_TIMING")
    os.environ["NTLINK_TIMING"] = "1"
    runs = {name: getattr(bench, name) for name in BENCH_RUNS}
    for name, n in BENCH_RUNS.items():
        setattr(bench, name, n)
    sketch_cuda.launches = 0
    alu_peak_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        workload = bench.build_workload()
        fields, detail = bench.device_run(dev, workload)
        line = bench.result_line(
            fields, bench.weak_host_rate(workload, bench.N_READS))
    finally:
        for name, n in runs.items():
            setattr(bench, name, n)
        if had is None:
            del os.environ["NTLINK_TIMING"]
        else:
            os.environ["NTLINK_TIMING"] = had
    launches = {"sketch_rows": sketch_cuda.launches,
                "alu_peak": alu_peak_cuda.launches}
    print(json.dumps(line), flush=True)
    if line["nvidia_smi"] != smi:
        fail(f"phase 11: the result line names {line['nvidia_smi']}")
    if min(launches.values()) == 0:
        fail(f"phase 11: launches {launches}")
    tallies = detail["tallies"]
    if not (tallies["device"] == tallies["hybrid"] == tallies["host_strong"]
            and len(tallies["device"]) > 0):
        fail("phase 11: the legs' tallies differ")
    # the bytes of the batches that ran: every read pads to one length,
    # and a row is its 2-bit codes and its int32 length
    leg, mapper = detail["device_leg"], detail["mapper"]
    pad = next_pow2(bench.READ_LEN)
    heights = stream_batches(len(workload[1]), pad, mapper.batch_bases)
    if not set((B, pad) for B in heights) <= set(bench_shapes()):
        fail(f"phase 11: batch heights {sorted(set(heights))} at pad {pad} "
             f"that phase 1 did not hold against the plain version")
    rows = leg["runs"] * sum(heights)
    if leg["batches_by_pad"] != {(pad, False): leg["runs"] * len(heights)}:
        fail(f"phase 11: batches by pad {leg['batches_by_pad']}, expected "
             f"{leg['runs'] * len(heights)} at pad {pad}")
    if leg["wire_stats"]["h2d"] != rows * (pad // 4 + 4):
        fail(f"phase 11: wire_stats h2d {leg['wire_stats']['h2d']} != "
             f"{rows} rows x {pad // 4 + 4} bytes")
    timing, wall = leg["timing"], leg["stream_seconds"]
    # the runs-only consumer keys its tally alone, and no read of the bench
    # needs the exact host path
    absent = {"host_remap", "group_gather", "chain_render", "verbose_write"}
    for thread, keys in PhaseTimer.THREADS.items():
        missing = [k for k in keys
                   if k not in absent and timing.get(k, (0.0, 0))[1] <= 0]
        if missing:
            fail(f"phase 11: no {missing} in the timing split")
        total = sum(timing.get(k, (0.0, 0))[0] for k in keys)
        if total > wall:
            fail(f"phase 11: the {thread} thread's phases sum to "
                 f"{total:.3f} s, past the stream's {wall:.3f} s wall")
    if set(timing) - absent != {k for keys in PhaseTimer.THREADS.values()
                                for k in keys} - absent:
        fail(f"phase 11: timing keys {sorted(timing)}")
    for text in bench.timing_lines(smi, timing, wall):
        log("phase 11:", text.lstrip("# "))
    log(f"phase 11: {smi}: device busy {leg['device_busy_s']:.3f} s of "
        f"{leg['profiled_wall_s']:.3f} s wall "
        f"({leg['device_busy_s'] / leg['profiled_wall_s']:.2%}; one more "
        f"run, profiler on)")
    log(f"phase 11: {smi}: device leg {line['device_reads_per_s']:.1f} "
        f"reads/s best of {leg['runs']} (median "
        f"{line['device_median_reads_per_s']:.1f}), hybrid "
        f"{line['hybrid_reads_per_s']:.1f} (median "
        f"{line['hybrid_median_reads_per_s']:.1f}, device share "
        f"{line['hybrid_device_share']:.2f}), strong host "
        f"{line['host_strong_reads_per_s']:.1f} (median "
        f"{line['host_strong_interleaved_median_reads_per_s']:.1f}), weak "
        f"host {line['host_weak_reads_per_s']:.1f}; {line['pairs']} pairs "
        f"in every leg; h2d {leg['wire_stats']['h2d']} bytes = {rows} rows "
        f"x {pad // 4 + 4}, d2h {leg['wire_stats']['d2h']} bytes; "
        f"{time.perf_counter() - t0:.1f} s for the phase")
    left = [c for c in child_processes() if c not in children]
    if left:
        fail(f"phase 11: the bench left processes {left}")
    return launches


def scale_dir(need: int) -> str:
    """A directory for phase 13 on a file system with `need` bytes free:
    the temporary directory's, else the checkout's."""
    for base in (tempfile.gettempdir(), REPO):
        room = scale.host_room(base)
        log(f"phase 13: df {base}: {room['disk_free'] / 2**30:.1f} GiB "
            f"free; free: {room['mem_available'] / 2**30:.1f} GiB of "
            f"{room['mem_total'] / 2**30:.1f} GiB available")
        if room["mem_available"] < SCALE_MEM_BYTES:
            fail(f"phase 13: {room['mem_available'] / 2**30:.1f} GiB of "
                 f"memory available, the phase needs "
                 f"{SCALE_MEM_BYTES / 2**30:.0f} GiB")
        if room["disk_free"] >= need:
            return base
    fail(f"phase 13: no file system with {need / 2**30:.1f} GiB free for "
         f"the human-scale files")


def contig_batch(target: str, k: int, w: int):
    """The contig sketcher's first 8 x 2^21 batch of `target`: its first
    contigs cut into window-aligned chunks as `TorchSketcher` cuts a
    sequence past MAX_PAD. Returns (codes (8, 2^21) uint8, lengths)."""
    B = batch_rows(CONTIG_PAD, TorchSketcher("cpu").batch_bases)
    S = CONTIG_PAD - (k + w - 2)
    rows = []
    for _, codes in stream_codes(target):
        M = len(codes) - (k + w - 2)
        for lo in range(0, M, S):
            rows.append(codes[lo : min(lo + S, M) + (k + w - 2)])
        if len(rows) >= B:
            break
    batch = np.zeros((B, CONTIG_PAD), np.uint8)
    lengths = np.zeros(B, np.int32)
    for r, row in enumerate(rows[:B]):
        batch[r, : len(row)] = row
        lengths[r] = len(row)
    return batch, lengths


def phase_scale(dev, smi: str) -> dict:
    """Phase 13: a human-size contig index resident on the card. The target
    is sketched three times (SCALE_SKETCHES: at the default knobs, auto at
    t=4, the card and four C threads; pinned to the card alone,
    backend=jax; at the default knobs again), each with the sketch
    kernel's count set to 0 just before it and read just after, and the
    TSVs must be byte-identical; then `scale.bounded_run` builds the index
    from the first TSV, with the count set to 0 again."""
    n_reads = scale.BOUNDED_READS
    need = scale.stress_bytes(SCALE_CONTIGS, SCALE_CONTIG_LEN, n_reads) \
        + (len(SCALE_SKETCHES) - 1) * scale.sketch_tsv_bytes(
            SCALE_CONTIGS, SCALE_CONTIG_LEN)
    base = scale_dir(need + (1 << 30))
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ntlink_scale_", dir=base) as d:
        t0 = time.perf_counter()
        with clock("13 write"):
            scale.write_stress_dataset(d, SCALE_CONTIGS, SCALE_CONTIG_LEN,
                                       n_reads)
        log(f"phase 13: {SCALE_CONTIGS} contigs x {SCALE_CONTIG_LEN} b and "
            f"{n_reads} reads of {scale.READ_LEN} b written in "
            f"{time.perf_counter() - t0:.1f} s (the generator of "
            f"scripts/stress_scale_torch.py)")
        # the contig sketch at the default knobs, on the card alone, and at
        # the default knobs again, each through a link to the target in a
        # directory of its own (the TSV is written beside the target); the
        # bounded run then reuses the first one's TSV, beside the target
        sketches = {}
        lengths = pipeline.read_scaffold_lengths(os.path.join(d, "target.fa"))
        for name, backend, sub in SCALE_SKETCHES:
            target = os.path.join(d, "target.fa")
            if sub:
                os.makedirs(os.path.join(d, sub))
                os.symlink(target, os.path.join(d, sub, "target.fa"))
                target = os.path.join(d, sub, "target.fa")
            sketch_cuda.launches = 0
            with clock(f"13 sketch, {name}"):
                tsv, r = scale.sketch_target(
                    target, backend, device=dev, lengths=lengths,
                    log=lambda *a: log("phase 13:", *a))
            kind = "TorchSketcher" if backend == "jax" \
                else "TorchHybridSketcher"
            # every contig the card took is chunked (a contig that a stall
            # rescue ran on both paths counts in `chunked` and not in
            # `device_seqs`)
            if r["sketcher"] != kind or r["device_seqs"] < 1 \
                    or r["device_seqs"] + r["host_seqs"] != SCALE_CONTIGS \
                    or r["chunked"] < r["device_seqs"] \
                    or (kind == "TorchSketcher"
                        and r["chunked"] != SCALE_CONTIGS) \
                    or r["host_fallbacks"] != 0 \
                    or not (r["launches"] == r["device_batches"]
                            == sketch_cuda.launches > 0):
                fail(f"phase 13: the contig sketch, {name}: {r['sketcher']}, "
                     f"card {r['device_seqs']} and host {r['host_seqs']} "
                     f"contigs, {r['chunked']} chunked, "
                     f"{r['host_fallbacks']} host-fallback rows, "
                     f"{sketch_cuda.launches} launches for "
                     f"{r['device_batches']} batches")
            sketches[name] = (tsv, r)
        first_tsv = sketches[SCALE_SKETCHES[0][0]][0]
        for name, (tsv, _) in sketches.items():
            if not filecmp.cmp(tsv, first_tsv, shallow=False):
                fail(f"phase 13: the TSV of the contig sketch, {name}, "
                     f"differs from the default's")
        for name, (_, r) in sketches.items():
            log(f"phase 13: {smi}: contig sketch, {name}: "
                f"{r['seconds']:.1f} s with the TSV, card "
                f"{r['device_seqs']} of {SCALE_CONTIGS} contigs "
                f"({100 * r['device_share']:.1f}%), {r['launches']} "
                f"launches, peak host RSS {r['peak_rss_gib']:.2f} GiB "
                f"(sampled; {r['rss_before_gib']:.2f} GiB before); "
                f"{step_graph.summary(r['step_graphs'])}")
        log(f"phase 13: the {len(sketches)} TSVs byte-identical "
            f"({os.path.getsize(first_tsv)} bytes)")
        sketch_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            with clock("13 bounded run"):
                out = scale.bounded_run(d, n_reads, device=dev,
                                        check_reads=scale.CHECK_READS,
                                        log=lambda *a: log("phase 13:", *a))
        except scale.ScaleCheckError as exc:
            fail(f"phase 13: {exc}")
        launches = sketch_cuda.launches
        table, mp = out["table"], out["mapping"]
        n_min = out["parse"]["minimizers"]
        if table["regime"] != "load-4" or table["entries"] != n_min:
            fail(f"phase 13: {n_min} minimizers, a table of "
                 f"{table['entries']} entries in the {table['regime']} "
                 f"regime")
        if "sketch" in out or mp["launches"] == 0 \
                or mp["launches"] != launches:
            fail(f"phase 13: the bounded run launched {launches} kernels, "
                 f"its read mapping {mp['launches']}, and sketched the "
                 f"target again: {'sketch' in out}")
        if out["payloads_checked"] < scale.CHECK_READS \
                or mp["reads"] != n_reads:
            fail(f"phase 13: {mp['reads']} reads mapped, "
                 f"{out['payloads_checked']} payloads checked")
        log(f"phase 13: {smi}: {n_min} minimizers of "
            f"{out['target_bases']} bases; table {table['nb']} buckets "
            f"(load-4), max_probes {table['max_probes']}, {table['bytes']} "
            f"bytes, built in {table['seconds']:.1f} s, uploaded in "
            f"{out['upload']['seconds']:.2f} s and read back equal; "
            f"{mp['reads_per_s']:.1f} reads/s with chaining on the card, "
            f"{out['payloads_checked']} payloads equal to HostMapper's; "
            f"peak device memory {mp['peak_device_mib']:.1f} MiB, peak host RSS "
            f"{mp['peak_rss_gib']:.2f} GiB; {launches} sketch kernel "
            f"launches, all read mapping; "
            f"{step_graph.summary(mp['step_graphs'])}")
        # the kernel on the sketch's own contig batch, after the count was
        # read: the launches of the comparison and the timing do not count
        k, w = scale.K, scale.W
        codes_np, lengths_np = contig_batch(os.path.join(d, "target.fa"),
                                            k, w)
    codes = torch.from_numpy(codes_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    err = compare(sketch_cuda.sketch_rows(codes, lengths, k, w),
                  sketch_torch.sketch_rows_ref(codes, lengths, k, w),
                  lengths, k)
    if err != 0.0:
        fail("phase 13: kernel != plain version on the contig batch")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: sketch_cuda.sketch_rows(codes, lengths, k, w),
                 flush=flush)
    bound_ms, bound_by = sketch_bound_ms(*codes.shape, k, w)
    log(f"phase 13: {smi}: sketch kernel on the 3 Gbase sketch's first "
        f"contig batch ({codes.shape[0]} x {codes.shape[1]}): "
        f"max_abs_err={err}, {ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), share of bound {bound_ms / ms:.3f}; "
        f"{time.perf_counter() - t_phase:.1f} s for the phase, its files "
        f"removed")
    return {"launches": {"13 read mapping": launches,
                         **{f"13 contig sketch, {name}": r["launches"]
                            for name, (_, r) in sketches.items()}},
            "scale_contig_batch_ms": ms,
            "scale_contig_batch_bound_ms": bound_ms,
            "scale_contig_batch_share_of_bound": bound_ms / ms,
            "scale_sketch_gbase_per_s": {
                name: r["gbase_per_s"] for name, (_, r) in sketches.items()}}


def phase_new_paths(dev) -> dict:
    """Phases 7-10 and 12 on the smaller draft with its reads in two files; the
    references are one-process, one-device card runs of the port's CLI."""
    kwz = "k32.w100.z1000"
    must = [f"target.fa.{kwz}.ntLink.scaffolds.gap_fill.fa",
            f"target.fa.{kwz}.ntLink.scaffolds.fa",
            f"target.fa.{kwz}.trimmed_scafs.agp",
            PREFIX + ".verbose_mapping.tsv", PREFIX + ".n1.scaffold.dot"]
    with tempfile.TemporaryDirectory(prefix="ntlink_smoke_") as root:
        data = os.path.join(root, "data")
        os.makedirs(data)
        write_dataset(data, label="phase 7", **SMALL)
        split_read_files(data)
        inputs = [os.path.join(data, f)
                  for f in ("target.fa", "reads1.fa", "reads2.fa")]
        one_scaffold = make_dir(root, "one_scaffold", inputs)
        t0 = time.perf_counter()
        if run_in(one_scaffold, lambda: cli.main(SCAF2_ARGV)) != 0:
            fail("phase 7: the one-process scaffold run failed")
        log(f"phase 7: one process, scaffold gap_fill on the card: "
            f"{time.perf_counter() - t0:.1f} s")
        one_pair = make_dir(root, "one_pair", inputs)
        card_pair(one_pair, PAIR2_ARGV, dev, "phase 7 (one process, pair)")
        with clock("7"):
            by_path = phase_ranks(root, inputs, one_scaffold, one_pair, must)
        with clock("8"):
            by_path.update(phase_replicas(dev, root, data, one_pair))
        with clock("9"):
            by_path.update(phase_tracing(dev, root, inputs, one_scaffold,
                                         must))
        with clock("10"):
            phase_numpy(root, inputs, one_pair)
        with clock("12"):
            by_path.update(phase_launchers(root, inputs, one_pair))
    return by_path


class SketchKilled(RuntimeError):
    """The failure phase 14a injects into the contig sketch's step."""


def batches_of(sketcher, mapper) -> int:
    """Device batches of the latest flow's contig sketch and read mapping
    (None for a stage that did not run): one sketch kernel launch each."""
    return sum(sum(obj.batches_by_pad.values())
               for obj in (sketcher, mapper) if obj is not None)


def card_flow(d: str, argv, label: str):
    """The port's CLI on the card in `d`, the sketch kernel's count set to 0
    just before and read just after. Returns (launches, wall seconds)."""
    pipeline.last_sketcher = pipeline.last_mapper = None
    sketch_cuda.launches = 0
    t0 = time.perf_counter()
    rc = run_in(d, lambda: cli.main(argv))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = sketch_cuda.launches
    if rc != 0:
        fail(f"{label}: the port's {argv[0]} exited {rc}")
    batches = batches_of(pipeline.last_sketcher, pipeline.last_mapper)
    if launches != batches:
        fail(f"{label}: {launches} sketch kernel launches for {batches} "
             f"device batches")
    log(f"{label}: {launches} launches for {batches} device batches; "
        f"{contig_split(pipeline.last_sketcher)}")
    return launches, secs


def contig_split(sketcher) -> str:
    """Where the latest flow's contig sketch ran, for a log line."""
    if sketcher is None:
        return "no contig sketch ran"
    if not isinstance(sketcher, TorchHybridSketcher):
        return "contig sketch on the card alone"
    return (f"contig sketch: card {sketcher.device_seqs}, host "
            f"{sketcher.host_seqs} contigs")


def cpu_flow(d: str, argv):
    """The same command line's flow on the CPU (the plain version in every
    batch). Returns (device batches, wall seconds)."""
    targets, cfg, rounds = cli.parse(argv)
    pipeline.last_sketcher = pipeline.last_mapper = None
    t0 = time.perf_counter()
    run_in(d, lambda: cli.dispatch(targets, cfg, rounds, "cpu"))
    return (batches_of(pipeline.last_sketcher, pipeline.last_mapper),
            time.perf_counter() - t0)


def mtimes(d: str) -> dict:
    """Each file's mtime, and for each symlink (the inputs, and the final
    scaffolds' link that every run sets again) the name it points at."""
    out = {}
    for name in os.listdir(d):
        path = os.path.join(d, name)
        out[name] = (os.readlink(path) if os.path.islink(path)
                     else os.stat(path).st_mtime_ns)
    return out


def phase_reuse(dev, root: str, data: str) -> dict:
    """Phase 14a: Make-style reuse on the card (tests/test_incremental.py).
    Returns the launches by case."""
    inputs = [os.path.join(data, f) for f in ("target.fa", "reads.fa")]
    d = make_dir(root, "p14a", inputs)
    dot = os.path.join(d, PREFIX + ".n1.scaffold.dot")
    first, secs = card_flow(d, SCAF_ARGV, "phase 14a")
    if first == 0:
        fail("phase 14a: the first scaffold launched no sketch kernel")
    log(f"phase 14a (first scaffold): {first} sketch kernel launches, "
        f"{secs:.1f} s")
    stamps = mtimes(d)
    with open(dot, "rb") as fh:
        first_dot = fh.read()
    again, secs = card_flow(d, SCAF_ARGV, "phase 14a")
    changed = sorted(n for n, t in mtimes(d).items() if stamps.get(n) != t)
    if again != 0 or changed or len(stamps) != len(os.listdir(d)):
        fail(f"phase 14a: the second scaffold launched {again} sketch "
             f"kernels and changed {changed}")
    log(f"phase 14a (second scaffold): {again} sketch kernel launches, "
        f"{secs:.1f} s; every file's mtime and every link unchanged "
        f"({len(stamps)} names)")
    os.utime(os.path.join(data, "reads.fa"))
    remap, secs = card_flow(d, SCAF_ARGV, "phase 14a")
    mapper = pipeline.last_mapper
    with open(dot, "rb") as fh:
        same = fh.read() == first_dot
    if pipeline.last_sketcher is not None or mapper is None \
            or remap == 0 or mapper.kernel_launches != remap:
        fail(f"phase 14a: after the reads were touched: {remap} launches, "
             f"contig sketch {pipeline.last_sketcher}, mapper {mapper}")
    if not same or os.stat(dot).st_mtime_ns <= stamps[os.path.basename(dot)]:
        fail("phase 14a: the DOT after the reads were touched is not a new "
             "file with the first run's bytes")
    log(f"phase 14a (reads touched): {remap} sketch kernel launches, all "
        f"read mapping ({mapper.device_reads} reads on the card; the contig "
        f"sketch reused), {secs:.1f} s; DOT rewritten, byte-identical to the "
        f"first ({len(first_dot)} bytes)")
    # a contig sketch that dies on the card: on the card alone after its
    # first batch, and at the default knobs (the hybrid) at the card's
    # first batch, which the scheduler always hands the card
    cases = (("card alone", "jax", KILL_AFTER_STEPS), ("default", "auto", 0))
    killed_launches = {}
    for name, backend, after in cases:
        kd = make_dir(root, f"p14a_killed_{backend}", inputs[:1])
        cfg = cli.parse(SCAF_ARGV + [f"backend={backend}"])[1]
        real_step, calls = sketch_mod.sketch_step, [0]

        def dying_step(*args, **kwargs):
            calls[0] += 1
            if calls[0] > after:
                raise SketchKilled(f"sketch step {calls[0]} killed")
            return real_step(*args, **kwargs)

        sketch_mod.sketch_step = dying_step
        sketch_cuda.launches = 0
        t0 = time.perf_counter()
        try:
            run_in(kd, lambda: pipeline.ensure_contig_sketch_tsv(
                cfg, cfg.k, cfg.w, device=dev))
            killed = False
        except SketchKilled:
            killed = True
        finally:
            sketch_mod.sketch_step = real_step
        torch.cuda.synchronize()
        launches = sketch_cuda.launches
        left = sorted(set(os.listdir(kd)) - {"target.fa"})
        kind = TorchSketcher if backend == "jax" else TorchHybridSketcher
        if not killed or launches != after or left \
                or type(pipeline.last_sketcher) is not kind:
            fail(f"phase 14a: killed sketch ({name}): raised {killed}, "
                 f"{launches} launches, left {left}")
        log(f"phase 14a (sketch killed at step {after + 1}, {name}, "
            f"{type(pipeline.last_sketcher).__name__}): {launches} sketch "
            f"kernel launches before it, {time.perf_counter() - t0:.1f} s; "
            f"neither the TSV nor a .tmp left")
        killed_launches[f"14a killed sketch, {name}"] = launches
    return {"14a first scaffold": first, "14a reads touched": remap,
            **killed_launches}


def phase_lifted(root: str) -> dict:
    """Phase 14b: on a draft whose second round still joins
    (`write_rounds_dataset` of tests/torch_port/synthetic.py), round 1 on
    the card, then round 2 on the card from the lifted mapping (with
    `pipeline.map_reads` made to raise) and from a fresh remap
    (tests/test_rounds_neutrality.py): the same DOT, path and FASTA, with
    fewer scaffolds than round 1 left."""
    data = os.path.join(root, "p14b_data")
    # by its path: a package named `tests` may be installed on the machine
    spec = importlib.util.spec_from_file_location(
        "ntlink_smoke_synthetic",
        os.path.join(REPO, "tests", "torch_port", "synthetic.py"))
    synthetic = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synthetic)
    synthetic.write_rounds_dataset(data)
    reads = os.path.join(data, "reads.fa")
    round1 = make_dir(root, "p14b_round1",
                      [os.path.join(data, "target.fa"), reads])
    round1_launches, secs = card_flow(round1, SCAF_ARGV,
                                      "phase 14b (round 1)")
    final = os.path.realpath(os.path.join(round1, PREFIX
                                          + ".ntLink.scaffolds.fa"))
    n1 = len(list(stream_fastx(final)))
    log(f"phase 14b (round 1): {round1_launches} sketch kernel launches, "
        f"{n1} scaffolds, {secs:.1f} s")
    runs = {}
    for name in ("lifted", "fresh"):
        d = make_dir(root, f"p14b_{name}", [reads])
        shutil.copy(final, os.path.join(d, "round1.fa"))
        shutil.copy(os.path.join(round1, PREFIX + ".trimmed_scafs.agp"),
                    os.path.join(d, "round1.fa.agp"))
        shutil.copy(os.path.join(round1, PREFIX + ".verbose_mapping.tsv"),
                    os.path.join(d, "round1.fa.verbose_mapping.tsv"))
        real_map = pipeline.map_reads
        if name == "lifted":
            liftover_mappings(
                os.path.join(d, "round1.fa.verbose_mapping.tsv"),
                os.path.join(d, "round1.fa.agp"),
                os.path.join(d, ROUND2_PREFIX + ".verbose_mapping.tsv"), 32)

            def boom(*args, **kwargs):
                raise AssertionError("the lifted checkpoint was not used")

            pipeline.map_reads = boom
        try:
            launches, secs = card_flow(d, ROUND2_ARGV, f"phase 14b ({name})")
        finally:
            pipeline.map_reads = real_map
        sk, mp = pipeline.last_sketcher, pipeline.last_mapper
        by_stage = (sk.kernel_launches if sk else 0,
                    mp.kernel_launches if mp else 0)
        runs[name] = (d, launches, by_stage)
        log(f"phase 14b ({name} round 2): {launches} sketch kernel launches "
            f"({by_stage[0]} contig sketch, {by_stage[1]} read mapping), "
            f"{secs:.1f} s")
    if runs["lifted"][2][1] != 0 or runs["lifted"][1] != runs["lifted"][2][0]:
        fail(f"phase 14b: the lifted round launched {runs['lifted'][1:]}")
    if min(runs["fresh"][2]) == 0:
        fail(f"phase 14b: the fresh round launched {runs['fresh'][1:]}")
    a, b = runs["lifted"][0], runs["fresh"][0]
    for name in (ROUND2_PREFIX + ".n1.scaffold.dot",
                 ROUND2_PREFIX + ".stitch.path",
                 ROUND2_PREFIX + ".ntLink.scaffolds.fa"):
        pa = os.path.realpath(os.path.join(a, name))
        pb = os.path.realpath(os.path.join(b, name))
        if not filecmp.cmp(pa, pb, shallow=False):
            fail(f"phase 14b: {name} of the lifted round differs from the "
                 f"fresh remap's")
        log(f"phase 14b: {name}: lifted == fresh remap "
            f"({os.path.getsize(pa)} bytes)")
    n2 = len(list(stream_fastx(os.path.join(
        a, ROUND2_PREFIX + ".ntLink.scaffolds.fa"))))
    if n2 >= n1:
        fail(f"phase 14b: round 2 left {n2} scaffolds of round 1's {n1}")
    log(f"phase 14b: round 2 joined {n1} scaffolds into {n2}")
    return {"14b round 1": round1_launches,
            "14b lifted round 2": runs["lifted"][1],
            "14b fresh round 2": runs["fresh"][1]}


def truth_genome(rng, n_contigs=6, contig_len=400_000, gap=500):
    """tests/test_synthetic_truth.py's `make_genome`: a random genome cut
    into contigs with known gaps. Returns (genome, [(name, seq)])."""
    pieces, contigs = [], []
    for i in range(n_contigs):
        seq = "".join(TRUTH_BASES[rng.integers(0, 4, contig_len)])
        contigs.append((f"contig{i}", seq))
        pieces.append(seq)
        if i + 1 < n_contigs:
            pieces.append("".join(TRUTH_BASES[rng.integers(0, 4, gap)]))
    return "".join(pieces), contigs


def truth_reads(rng, genome, n_reads=800, read_len=12_000, err=0.03):
    """tests/test_synthetic_truth.py's `sample_reads`: substitutions at
    `err`, half reverse-complemented."""
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for r in range(n_reads):
        start = int(rng.integers(0, len(genome) - read_len))
        arr = np.frombuffer(
            genome[start : start + read_len].encode(), dtype=np.uint8
        ).copy()
        n_err = int(read_len * err)
        pos = rng.integers(0, read_len, n_err)
        arr[pos] = TRUTH_BASES[rng.integers(0, 4, n_err)].astype(
            "S1").view(np.uint8)
        seq = arr.tobytes().decode()
        if rng.random() < 0.5:
            seq = seq.translate(comp)[::-1]
        reads.append((f"r{r}", seq))
    return reads


def card_and_cpu(root: str, name: str, files: dict, argv, label: str,
                 must=()):
    """`files` ({name: records}) written into two directories, then the
    flow of `argv` on the card in one and on the CPU in the other; the
    directories must be equal. Returns (card directory, launches)."""
    dirs = []
    for side in ("card", "cpu"):
        d = os.path.join(root, f"{name}_{side}")
        os.makedirs(d)
        for fname, records in files.items():
            with open(os.path.join(d, fname), "w") as fh:
                write_fasta(fh, records)
        dirs.append(d)
    launches, card_s = card_flow(dirs[0], argv, label)
    batches, cpu_s = cpu_flow(dirs[1], argv)
    if launches != batches or (batches and not launches):
        fail(f"{label}: {launches} sketch kernel launches on the card, "
             f"{batches} device batches on the CPU")
    same_tree(label, dirs[0], dirs[1], must)
    log(f"{label}: {launches} sketch kernel launches ({batches} batches on "
        f"the CPU), card {card_s:.1f} s, CPU {cpu_s:.1f} s")
    return dirs[0], launches


def phase_truth(root: str) -> dict:
    """Phase 14c: the genome of known truth (tests/test_synthetic_truth.py)
    on the card and on the CPU."""
    rng = np.random.default_rng(11)
    genome, contigs = truth_genome(rng)
    files = {"target.fa": contigs, "reads.fa": truth_reads(rng, genome)}
    final = PREFIX + ".ntLink.scaffolds.fa"
    d, launches = card_and_cpu(root, "p14c", files, SCAF_ARGV,
                               "phase 14c (truth)",
                               [final, PREFIX + ".stitch.path"])
    with open(os.path.join(d, PREFIX + ".stitch.path")) as fh:
        paths = [line.rstrip("\n").split("\t")[1] for line in fh]
    tokens = paths[0].split(" ") if len(paths) == 1 else []
    names = [t[:-1] for t in tokens[::2]]
    oris = [t[-1] for t in tokens[::2]]
    gaps = [int(t[:-1]) for t in tokens[1::2]]
    want = [name for name, _ in contigs]
    if names != want:
        names = names[::-1]
        oris = ["-" if o == "+" else "+" for o in oris[::-1]]
    if names != want or len(set(oris)) != 1 \
            or not all(200 <= g <= 800 for g in gaps) \
            or len(list(stream_fastx(os.path.join(d, final)))) != 1:
        fail(f"phase 14c: paths {paths} are not the truth (6 contigs in "
             f"order, one orientation, gaps of 500 within 200-800)")
    log(f"phase 14c: one path in truth order, gap estimates {gaps} "
        f"(truth 500)")
    rng = np.random.default_rng(12)
    genome, contigs = truth_genome(rng, n_contigs=3, contig_len=300_000)
    files = {"target.fa": contigs,
             "reads.fa": truth_reads(rng, genome, n_reads=500)}
    gap_final = PREFIX + ".ntLink.scaffolds.gap_fill.fa"
    d, gf_launches = card_and_cpu(root, "p14c_gap_fill", files,
                                  ["scaffold", "gap_fill"] + SCAF_ARGV[1:],
                                  "phase 14c (gap fill)", [gap_final])
    big = max((r.seq for r in stream_fastx(os.path.join(d, gap_final))),
              key=len)
    n_share = big.upper().count("N") / len(big)
    if abs(len(big) - len(genome)) >= 0.02 * len(genome) or n_share >= 0.01:
        fail(f"phase 14c: gap-filled scaffold of {len(big)} b ({n_share:.4%} "
             f"N) for a genome of {len(genome)} b")
    log(f"phase 14c (gap fill): largest scaffold {len(big)} b for a genome "
        f"of {len(genome)} b, {n_share:.4%} N")
    return {"14c truth": launches, "14c gap fill": gf_launches}


def phase_degenerate(root: str) -> dict:
    """Phase 14d: degenerate inputs (tests/test_edge_cases.py), each on the
    card and on the CPU."""
    rng = np.random.default_rng(SEED + 14)

    def seq(n):
        return "".join(TRUTH_BASES[rng.integers(0, 4, n)])

    c1, c2 = seq(3000), seq(2500)
    k, w = 32, 100
    gap_argv = ["scaffold", "gap_fill"] + SCAF_ARGV[1:]
    cases = [
        ("empty reads", {"target.fa": [("c1", c1)], "reads.fa": []},
         SCAF_ARGV),
        ("reads that map nowhere",
         {"target.fa": [("c1", c1), ("c2", c2)],
          "reads.fa": [("r1", seq(2000))]}, SCAF_ARGV),
        ("sub-k contigs",
         {"target.fa": [("tiny", "ACGT"), ("c1", c1), ("short", c2[:k - 1])],
          "reads.fa": [("r1", c1[200:1700]), ("r2", seq(1500))]}, SCAF_ARGV),
        ("all-N contig and read",
         {"target.fa": [("c1", c1), ("nn", "N" * 2000)],
          "reads.fa": [("r1", c1[100:2100]), ("rn", "N" * 1500)]},
         SCAF_ARGV),
        ("reads of k, k+1, k+w-2",
         {"target.fa": [("c1", c1)],
          "reads.fa": [(f"r{n}", c1[500 : 500 + n])
                       for n in (k, k + 1, k + w - 2)]}, SCAF_ARGV),
        ("gap_fill with nothing to fill",
         {"target.fa": [("c1", c1)], "reads.fa": [("r1", seq(1500))]},
         gap_argv),
    ]
    by_case = {}
    for i, (name, files, argv) in enumerate(cases):
        _, launches = card_and_cpu(root, f"p14d_{i}", files, argv,
                                   f"phase 14d ({name})")
        by_case[f"14d {name}"] = launches
    return by_case


def phase_behaviours(dev, root: str) -> dict:
    """Phase 14: the JAX package's behaviour checks on the card, each case
    with the sketch kernel's count set to 0 just before it."""
    t0 = time.perf_counter()
    data = os.path.join(root, "p14_data")
    os.makedirs(data)
    write_dataset(data, label="phase 14", **SMALL)
    with clock("14a"):
        by_path = phase_reuse(dev, root, data)
    with clock("14b"):
        by_path.update(phase_lifted(root))
    with clock("14c"):
        by_path.update(phase_truth(root))
    with clock("14d"):
        by_path.update(phase_degenerate(root))
    # the flows ran with t=4: the layout sweep's pools started the resource
    # tracker
    left = stop_children()
    if left:
        fail(f"phase 14: processes left running: {left}")
    log(f"phase 14: {time.perf_counter() - t0:.1f} s for the phase")
    return by_path


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
    # the bound: the loop's vector-ALU instructions (LOP3, IADD3, IMAD in
    # the built library) at the INT32 instruction rate, against one read and one
    # write of the elements
    alu = sum(n for op, n in rates["sass_ops"][32].items()
              if op in ("LOP3", "IADD3", "IMAD"))
    by_ops = x.numel() * iters * alu / INT32_INSTR_PER_S
    by_bytes = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(by_ops, by_bytes)
    log(f"phase 1b: bound {bound_ms:.4f} ms ({alu} vector-ALU instructions "
        f"per iteration), share of bound {bound_ms / ms:.3f}")
    return {"max_abs_err": float(worst), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "share_of_bound": bound_ms / ms, "library_ms": None,
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


def graph_batches(rng, contigs, B: int, pad: int, has_n: bool, n: int = 3):
    """`n` batches of B - 1 reads of pad/2 .. pad bases cut from
    `contigs`, a few N in every third when `has_n`, and a padding row,
    packed as the streams pack them and pinned, as the streams hand them
    to a graph set."""
    out = []
    for _ in range(n):
        rows = []
        for r in range(B - 1):
            ln = int(rng.integers(pad // 2, pad + 1))
            c = contigs[r % len(contigs)]
            st = int(rng.integers(0, len(c) - ln))
            read = c[st : st + ln].copy()
            if has_n and r % 3 == 0:
                read[rng.integers(0, ln, 3)] = 4
            rows.append(read)
        lengths = np.zeros(B, np.int32)
        lengths[: len(rows)] = [len(c) for c in rows]
        packed, nmask = pack_batch(rows, B, pad, has_n)
        p, ln, nm = pinned(torch.device("cuda"), packed, lengths, nmask)
        out.append(dict(packed=p, lengths=ln, nmask=nm))
    return out


def hash_grid_cell(dev, rng, contigs, sidx, kind: str, pad: int,
                   has_n: bool, B: int, slots: int) -> None:
    """One hash-grid cell of phase 15: a hash-sharded step on the card
    named twice (a 1 x 2 grid, both cells on one device: one graph set,
    one replay a batch) takes three batches of one key; each payload,
    copied back in the grid's stream as the read stream does, must equal
    the same step's run eagerly (no graph set) on that batch."""
    k, w = 32, 100
    with_hashes = kind.endswith("hash planes")
    make = lambda: make_sharded_index_mapping_step(  # noqa: E731
        make_mesh_2d(len(TWO_CARDS), TWO_CARDS), sidx, k, w, pad, slots,
        with_hashes=with_hashes)
    step, eager = make(), make()
    eager.graphs = [None] * len(eager.groups)
    (g,) = step.graphs
    origin = step.cells[0][0]
    launches = sketch_cuda.launches
    held = []
    for b in graph_batches(rng, contigs, B, pad, has_n):
        with origin.work():
            held.append((b, *copy_back(step.flat(**b))))
    label = f"phase 15: {(kind, pad, has_n)}"
    if sketch_cuda.launches - launches != len(held) * len(TWO_CARDS) \
            or (g.captures, g.replays) != (1, len(held) - 1):
        fail(f"{label}: {sketch_cuda.launches - launches} launches, "
             f"{g.captures} captures, {g.replays} replays for {len(held)} "
             f"batches")
    for batch, host, event in held:
        event.synchronize()
        want = eager(batch["packed"], batch["lengths"],
                     nmask=batch["nmask"])["flat"].cpu()
        if not torch.equal(want, host):
            fail(f"{label}: a payload differs from the eager step's")
    if int(held[-1][1][0, :B].sum()) == 0:
        fail(f"{label}: the step found nothing")
    log(f"{label}: B={B} on {TWO_CARDS}, first batch eager, second "
        f"captured in {g.capture_seconds:.3f} s and replayed, third "
        f"replayed: each equal to the eager step")


def phase_graphs(dev, check: GraphCheck) -> dict:
    """Phase 15: the step graphs. Every key that the flows above replayed
    was held against the eager step as its phase ended (`GraphCheck`);
    here each cell of the grid (the sketch step, the mapping step's four
    payload kinds and the hash-sharded step on the card named twice,
    plain and with hash planes, at phase 1's pads, with and without N)
    that no flow replayed is made: a graph set of its own (for the hash
    grid, a step of its own, whose one device has one set), at the batch
    height of the flows' batches of bases, runs the step eagerly on one
    batch, captures and replays it on a second and replays it on a third;
    every payload must equal the eager step's on its own batch, byte for
    byte, and the kernel is counted once per batch (per batch and idx rank
    on the grid)."""
    t0 = time.perf_counter()
    missing = [c for c in GRAPH_CELLS if c not in check.cells]
    rng = np.random.default_rng(SEED + 15)
    k, w = 32, 100
    size = CONTIG_PAD + 100_000
    contigs = [rng.integers(0, 4, size).astype(np.uint8) for _ in range(3)]
    index = ContigIndex.from_sketches(
        (name, mins) for name, _, mins in sketch_mod.sketch_sequences(
            ((f"c{i}", c) for i, c in enumerate(contigs)), k, w, threads=3))
    didx = mapping_step.DeviceIndex.from_contig_index(index, dev)
    sidx = ShardedDeviceIndex.from_contig_index(index, len(TWO_CARDS))
    clen = torch.full((3,), size, dtype=torch.int32, device=dev)
    map_bases = cli.parse(PAIR_ARGV)[1].batch_bases
    sketcher = TorchSketcher("cpu")
    launches0 = sketch_cuda.launches
    for kind, pad, has_n in missing:
        slots = TorchMapper._slots_for(types.SimpleNamespace(w=w), pad)
        if kind.startswith("hash grid"):
            hash_grid_cell(dev, rng, contigs, sidx, kind, pad, has_n,
                           batch_rows(pad, map_bases), slots)
            continue
        if kind == "sketch":
            step = mapping_step.sketch_step
            B = batch_rows(pad, sketcher.batch_bases)
            static = dict(k=k, w=w, L=pad,
                          max_mins=sketcher._slots_for(pad, w))
        else:
            step = mapping_step.mapping_step
            B = batch_rows(pad, map_bases)
            static = dict(
                index=didx, k=k, w=w, L=pad, slots=slots,
                clen=clen if kind in ("anchors", "runs-only") else None,
                z=1000, runs=kind == "runs-only",
                with_hashes=kind == "hash planes")
        g = step_graph.StepGraphs(dev)
        launches = sketch_cuda.launches
        held = [(b, *copy_back(g.run(step, b, static)))
                for b in graph_batches(rng, contigs, B, pad, has_n)]
        if sketch_cuda.launches - launches != len(held) \
                or (g.captures, g.replays) != (1, len(held) - 1):
            fail(f"phase 15: {(kind, pad, has_n)}: "
                 f"{sketch_cuda.launches - launches} launches, "
                 f"{g.captures} captures, {g.replays} replays for "
                 f"{len(held)} batches")
        for batch, host, event in held:
            event.synchronize()
            eager = step(**{n: None if t is None else t.to(dev)
                            for n, t in batch.items()}, **static).cpu()
            if not torch.equal(eager, host):
                fail(f"phase 15: {(kind, pad, has_n)}: a payload differs "
                     f"from the eager step's")
        if int(held[-1][1][:B].sum()) == 0:
            fail(f"phase 15: {(kind, pad, has_n)}: the step found nothing")
        log(f"phase 15: {kind}, pad {pad}{', N' if has_n else ''}: "
            f"B={B}, first batch eager, second captured in "
            f"{g.capture_seconds:.3f} s and replayed, third replayed: each "
            f"equal to the eager step")
    sketch_cuda.launches = launches0
    from_flows = [c for c in GRAPH_CELLS if c in check.cells]
    log(f"phase 15: {len(GRAPH_CELLS)} cells of (kind, pad, N): "
        f"{len(from_flows)} replayed in the flows above "
        f"({sum(check.cells.values())} keys there, over "
        f"{len(check.cells)} cells in all), {len(missing)} made here; "
        f"{time.perf_counter() - t0:.1f} s")
    log("phase 15: keys held in the flows by cell: " + ", ".join(
        f"{kind}/{pad}{'N' if n else ''}: {c}"
        for (kind, pad, n), c in sorted(check.cells.items())))
    return {"cells_from_flows": len(from_flows), "cells_made": len(missing),
            "flow_keys": sum(check.cells.values())}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    try:
        result = run_phases()
    finally:
        left = stop_children()
    if left:
        fail(f"processes still running after the last phase: {left}")
    for line in result:
        print(line)
    sys.stdout.flush()
    return 0


@contextlib.contextmanager
def clock(name: str):
    """Keeps the wall seconds of the block under `name` in PHASE_SECONDS
    and logs them."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
        # not "phase <name>:", the header of a phase's own lines
        log(f"seconds of phase {name}: {PHASE_SECONDS[name]}")


def run_phases() -> list:
    """Every phase in order; returns the lines that end the output (the
    seconds of every phase and the two JSON lines), printed once no
    process of the run is left."""
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    check = GraphCheck()
    check.install()
    try:
        with clock("0"):
            smi = phase_environment()
        with clock("1"):
            kern = phase_kernel(dev)
        with clock("1b"):
            probe = phase_probe(dev)
        with clock("2-4"):
            counts = phase_slice(dev)
            check.verify("2-4")
        with clock("5"):
            rounds = phase_rounds(dev)
            check.verify("5")
        with clock("6"):
            kbench = phase_bench(dev)
        with clock("7-10, 12"):
            new_paths = phase_new_paths(dev)
            check.verify("7-10, 12")
        with clock("11"):
            entry = phase_bench_entry(dev, smi)
            check.verify("11")
        with clock("13"):
            human = phase_scale(dev, smi)
            check.verify("13")
        with clock("14"), tempfile.TemporaryDirectory(
                prefix="ntlink_smoke_") as root:
            behaviours = phase_behaviours(dev, root)
            check.verify("14")
        with clock("15"):
            graphs = phase_graphs(dev, check)
    finally:
        check.uninstall()
    PHASE_SECONDS["total"] = round(time.perf_counter() - t0, 1)
    counts["launches_by_path"]["5 run_rounds_gaps"] = rounds["launches"]
    counts["launches_by_path"]["6 kernel bench"] = kbench["sketch_rows"]
    counts["launches_by_path"].update(new_paths)
    counts["launches_by_path"]["11 bench entry"] = entry["sketch_rows"]
    counts["launches_by_path"].update(human.pop("launches"))
    counts["launches_by_path"].update(behaviours)
    log(f"nvidia-smi: {smi}")
    kernels = json.dumps({"kernels": [{
        "name": "sketch_rows",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "also_replaces": ALSO_REPLACES,
        **counts,
        **kern,
        **human,
        "step_graphs": graphs,
    }, {
        "name": "alu_peak",
        "route": "cuda",
        "source": PROBE_SOURCE,
        "replaces": PROBE_REPLACES,
        "launches": kbench["alu_peak"],
        "launches_by_path": {"6 kernel bench": kbench["alu_peak"],
                             "11 bench entry": entry["alu_peak"]},
        **probe,
    }]})
    seconds = (f"phase seconds ({smi}): "
               + json.dumps(PHASE_SECONDS, separators=(", ", ": ")))
    return [seconds, kernels, json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})]


if __name__ == "__main__":
    sys.exit(main())
