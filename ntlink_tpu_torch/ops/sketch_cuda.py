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

#: columns of a row that one block of the kernel owns (kMaxSeg in
#: csrc/sketch.cu): the seams between blocks fall on its multiples
SEGMENT = 4096

#: names of the kernel's phase counters (`sketch_rows(..., phases=)`)
PHASES = ("tables+bases", "hash", "can copy+group scans", "window combine",
          "winner+emit")

_lib = None
_tables: dict = {}


def _library():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("sketch")
        lib.ntl_sketch_rows.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        )
        lib.ntl_sketch_rows.restype = ctypes.c_int
        lib.ntl_sketch_tables.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.ntl_sketch_tables.restype = None
        lib.ntl_sketch_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.ntl_sketch_blocks_per_sm.restype = ctypes.c_int
        _lib = lib
    return _lib


def _rotated_seeds(k: int, dev: torch.device) -> torch.Tensor:
    """The kernel's (8 + 4k, 2) table of rotated ntHash2 seeds for `k` on
    `dev`, made once per (k, device)."""
    key = (k, dev)
    if key not in _tables:
        host = torch.empty((8 + 4 * k, 2), dtype=torch.int64)
        _library().ntl_sketch_tables(k, host.data_ptr())
        _tables[key] = host.to(dev)
    return _tables[key]


def blocks_per_sm(L: int, k: int, w: int) -> int:
    """Blocks of the kernel that fit one SM at once for rows of length L."""
    n = _library().ntl_sketch_blocks_per_sm(L, k, w)
    if n < 0:
        raise RuntimeError(f"CUDA error {-n} (L={L} k={k} w={w})")
    return n


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


def sketch_rows(codes: torch.Tensor, lengths: torch.Tensor, k: int, w: int,
                phases: torch.Tensor = None):
    """Sketch a (B, L) batch of N-free rows: (can, fwd, winner, emit) as in
    `sketch_torch.sketch_rows_ref`, on the device of `codes`. With `phases`
    (len(PHASES) zeroed int64 counters on the card) thread 0 of every block
    adds the clocks it spent in each phase of the kernel."""
    global launches
    _check(codes, lengths, k, w)
    if codes.device.type == "cpu":
        return sketch_rows_ref(codes, lengths, k, w)
    if codes.device.type != "cuda":
        raise ValueError(f"no sketch kernel for device {codes.device}")
    B, L = codes.shape
    if codes.data_ptr() % 16:
        codes = codes.clone()  # the kernel loads 16 bytes at a time
    fn = _library().ntl_sketch_rows
    NW = max(L - k - w + 2, 0)
    dev = codes.device
    can = torch.empty((B, L), dtype=torch.int64, device=dev)
    fwd = torch.empty((B, L), dtype=torch.bool, device=dev)
    winner = torch.empty((B, NW), dtype=torch.int32, device=dev)
    emit = torch.empty((B, NW), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        tables = _rotated_seeds(k, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            codes.data_ptr(), lengths.data_ptr(), tables.data_ptr(),
            can.data_ptr(), fwd.data_ptr(), winner.data_ptr(),
            emit.data_ptr(), B, L, k, w, stream,
            None if phases is None else phases.data_ptr(),
        )
    if err != 0:
        # e.g. 1 (invalid value): k and w need more shared memory or
        # threads per block than the card allows, or B * ceil(L / 4096)
        # blocks exceed the grid
        raise RuntimeError(
            f"sketch kernel launch failed: CUDA error {err} "
            f"(B={B} L={L} k={k} w={w})"
        )
    launches += 1
    return can, fwd, winner, emit
