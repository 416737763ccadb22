"""Time the sketch kernel against an earlier version of its source, on the
card, in one process.

    python3 -m ntlink_tpu_torch.kernel_compare PREVIOUS.cu

PREVIOUS.cu is an older ``ntlink_tpu_torch/csrc/sketch.cu`` with the same C
entry point (``ntl_sketch_rows``), e.g. ``git show <commit>:ntlink_tpu_torch/
csrc/sketch.cu > scratch/sketch_prev.cu``. Both are built with the port's
nvcc flags (the current one with ``-Xptxas -v``, whose report is printed),
checked against the plain version on the valid columns, and timed in turns
(previous, current, current, previous) at the main path's two batch shapes,
512 x 16384 and 8 x 2^21 at k = 32, w = 100: CUDA events, median of 10, a
64 MiB write between launches so that every launch finds the L2 cold. Prints
the byte bound (15 bytes per base at 3.35 TB/s) beside each time, and the
card's name and power limit. Then, for the current kernel at each shape: the
blocks that fit one SM, and the share of the blocks' clocks spent in each
phase (the kernel's own `phases` counters, read by thread 0 between its
barriers).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from .ops import build, sketch_cuda
from .ops.sketch_torch import sketch_rows_ref

K, W = 32, 100
SHAPES = ((512, 16384), (8, 1 << 21))
HBM_BYTES_PER_S = 3.35e12
BYTES_PER_BASE = 15


def bound_ms(B: int, L: int, k: int = K, w: int = W) -> float:
    """Least milliseconds for one call: codes read once, the four output
    planes written once, at the card's memory rate."""
    nw = max(L - k - w + 2, 0)
    return (B * L * (1 + 8 + 1) + B * nw * (4 + 1) + 4 * B) \
        / HBM_BYTES_PER_S * 1e3


def load_previous(src: str):
    out = os.path.join(build.BUILD_DIR, "libsketch-previous.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                   check=True)
    fn = ctypes.CDLL(out).ntl_sketch_rows
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(codes, lengths, k, w):
        B, L = codes.shape
        nw = max(L - k - w + 2, 0)
        dev = codes.device
        can = torch.empty((B, L), dtype=torch.int64, device=dev)
        fwd = torch.empty((B, L), dtype=torch.bool, device=dev)
        winner = torch.empty((B, nw), dtype=torch.int32, device=dev)
        emit = torch.empty((B, nw), dtype=torch.bool, device=dev)
        err = fn(codes.data_ptr(), lengths.data_ptr(), can.data_ptr(),
                 fwd.data_ptr(), winner.data_ptr(), emit.data_ptr(), B, L, k,
                 w, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"previous kernel: CUDA error {err}")
        return can, fwd, winner, emit

    return run


def equal_on_valid(out, ref, lengths, k) -> bool:
    L = out[0].shape[1]
    valid = (torch.arange(L, device=lengths.device)[None, :]
             <= (lengths.long() - k)[:, None])
    return (torch.equal(out[0][valid], ref[0][valid])
            and torch.equal(out[1][valid], ref[1][valid])
            and torch.equal(out[2], ref[2]) and torch.equal(out[3], ref[3]))


def cold_ms(fn, flush: torch.Tensor, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_shares(codes, lengths, k, w):
    """({phase: share of the blocks' clocks}, clocks in all) of one launch
    of the current kernel."""
    clocks = torch.zeros(len(sketch_cuda.PHASES), dtype=torch.int64,
                         device=codes.device)
    sketch_cuda.sketch_rows(codes, lengths, k, w, phases=clocks)
    torch.cuda.synchronize()
    c = clocks.cpu().numpy().astype(np.float64)
    return dict(zip(sketch_cuda.PHASES, (c / c.sum()).round(4).tolist())), \
        c.sum()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip())
    src = os.path.join(build.CSRC, "sketch.cu")
    res = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.devnull, src], capture_output=True, text=True)
    print(res.stderr.strip())
    previous = load_previous(sys.argv[1])
    rng = np.random.default_rng(4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for B, L in SHAPES:
        codes = torch.from_numpy(rng.integers(0, 4, (B, L), dtype=np.uint8))
        lengths = torch.from_numpy(
            rng.integers(L // 2, L + 1, B).astype(np.int32))
        codes, lengths = codes.to(dev), lengths.to(dev)
        ref = sketch_rows_ref(codes, lengths, K, W)
        for name, fn in (("previous", previous),
                         ("current", sketch_cuda.sketch_rows)):
            ok = equal_on_valid(fn(codes, lengths, K, W), ref, lengths, K)
            print(f"{B} x {L}: {name} kernel equals the plain version: {ok}")
            if not ok:
                return 1
        del ref
        ms = {"previous": [], "current": []}
        for name, fn in (("previous", previous),
                         ("current", sketch_cuda.sketch_rows),
                         ("current", sketch_cuda.sketch_rows),
                         ("previous", previous)):
            ms[name].append(cold_ms(lambda: fn(codes, lengths, K, W), flush))
        bound = bound_ms(B, L)
        cur = min(ms["current"])
        print(f"{B} x {L} (k={K} w={W}): previous {ms['previous']} ms, "
              f"current {ms['current']} ms, bound {bound:.4f} ms (bytes), "
              f"share of bound {bound / cur:.3f}, "
              f"speed-up {min(ms['previous']) / cur:.2f}x")
        shares, clocks = phase_shares(codes, lengths, K, W)
        per_sm = sketch_cuda.blocks_per_sm(L, K, W)
        print(f"{B} x {L}: current kernel: {per_sm} blocks per SM; "
              f"{clocks:.0f} block-clocks in all; by phase {shares}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
