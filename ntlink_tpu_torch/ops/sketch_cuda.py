"""Wrapper of the Hopper sketch kernel (``csrc/sketch.cu``).

`sketch_rows` launches the hand-written CUDA kernel for tensors on a CUDA
device and runs the plain version (`sketch_torch.sketch_rows_ref`) for
tensors on the CPU. There is no fallback between the two: a CUDA tensor
either launches the kernel or raises. The kernel is built with nvcc on the
first CUDA call (`ops.build`), never at import.
"""
from __future__ import annotations

import ctypes

import torch

from .sketch_torch import sketch_rows_ref

#: kernel launches so far; a caller that wants to show that a run went
#: through the kernel sets it to 0 before the run and reads it after
launches = 0

MAX_ROWS = 65535  # grid.y limit: one block row per sequence row

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from .build import load

        fn = load("sketch").ntl_sketch_rows
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(codes: torch.Tensor, lengths: torch.Tensor, k: int, w: int):
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(
            f"codes must be a (B, L) uint8 tensor, got {codes.dtype} "
            f"{tuple(codes.shape)}"
        )
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (
        codes.shape[0],
    ):
        raise ValueError(
            f"lengths must be a ({codes.shape[0]},) int32 tensor, got "
            f"{lengths.dtype} {tuple(lengths.shape)}"
        )
    if lengths.device != codes.device:
        raise ValueError("codes and lengths must be on the same device")
    if not (codes.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("codes and lengths must be contiguous")
    if k < 1 or w < 1:
        raise ValueError(f"need k >= 1 and w >= 1, got k={k} w={w}")


def sketch_rows(codes: torch.Tensor, lengths: torch.Tensor, k: int, w: int):
    """Sketch a (B, L) batch of N-free rows: (can, fwd, winner, emit) as in
    `sketch_torch.sketch_rows_ref`, on the device of `codes`."""
    global launches
    _check(codes, lengths, k, w)
    if codes.device.type == "cpu":
        return sketch_rows_ref(codes, lengths, k, w)
    if codes.device.type != "cuda":
        raise ValueError(f"no sketch kernel for device {codes.device}")
    B, L = codes.shape
    if B > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got {B}")
    fn = _kernel()
    NW = max(L - k - w + 2, 0)
    dev = codes.device
    can = torch.empty((B, L), dtype=torch.int64, device=dev)
    fwd = torch.empty((B, L), dtype=torch.bool, device=dev)
    winner = torch.empty((B, NW), dtype=torch.int32, device=dev)
    emit = torch.empty((B, NW), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            codes.data_ptr(), lengths.data_ptr(), can.data_ptr(),
            fwd.data_ptr(), winner.data_ptr(), emit.data_ptr(),
            B, L, k, w, stream,
        )
    if err != 0:
        # e.g. 1 (invalid value): k and w need more shared memory per
        # block than the card allows
        raise RuntimeError(
            f"sketch kernel launch failed: CUDA error {err} "
            f"(B={B} L={L} k={k} w={w})"
        )
    launches += 1
    return can, fwd, winner, emit
