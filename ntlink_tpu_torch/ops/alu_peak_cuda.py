"""Wrapper of the Hopper integer peak probe (``csrc/alu_peak.cu``).

`alu_peak` launches the hand-written CUDA kernel for a tensor on a CUDA
device and runs the plain version (`alu_peak_torch.alu_peak_ref`) for a
tensor on the CPU. There is no fallback between the two: a CUDA tensor
either launches the kernel or raises. The kernel is built with nvcc on the
first CUDA call (`ops.build`), never at import.
"""
from __future__ import annotations

import ctypes

import torch

from .alu_peak_torch import alu_peak_ref, check_args

#: kernel launches so far; a caller that wants to show that a run went
#: through the kernel sets it to 0 before the run and reads it after
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from .build import load

        fn = load("alu_peak").ntl_alu_peak
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def alu_peak(x: torch.Tensor, iters: int, width: int = 32) -> torch.Tensor:
    """`iters` iterations of the probe's DAG on every element of `x` (int32
    bit patterns of uint32 values), on the device of `x`."""
    global launches
    check_args(x, iters, width)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return alu_peak_ref(x, iters, width)
    if x.device.type != "cuda":
        raise ValueError(f"no alu_peak kernel for device {x.device}")
    fn = _kernel()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), iters, width,
                 stream)
    if err != 0:
        raise RuntimeError(
            f"alu_peak kernel launch failed: CUDA error {err} "
            f"(n={x.numel()} iters={iters} width={width})"
        )
    launches += 1
    return out
