"""The integer peak probe in plain PyTorch.

Counterpart of the Pallas microkernel in ``bench.py::_kernel_bench``
(``make_micro.kern``, :250-276): a throughput-shaped uint32 DAG per
element, `iters` times over, which measures how many integer operations a
chip issues per second. `alu_peak_ref` is the plain version of the
hand-written Hopper kernel ``ntlink_tpu_torch/csrc/alu_peak.cu`` (wrapper:
``ops/alu_peak_cuda.py``): same input, same output, bit for bit.

Per iteration, with ``h = width // 2``:

    t_i = a ^ (0x9E3779B1 + i),  u_i = b + (0x85EBCA6B + i),  v_i = t_i + u_i
    a, b = v_0 ^ ... ^ v_{h/2-1},  v_{h/2} + ... + v_{h-1}

and the output is ``a ^ b`` (the start: ``b = a ^ 0xDEADBEEF``). Values are
uint32 bit patterns held in int32 tensors; the math runs in int64 with a
32-bit mask after every add, since PyTorch's uint32 arithmetic is thin on
the CPU.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
B0 = 0xDEADBEEF
T0 = 0x9E3779B1
U0 = 0x85EBCA6B
WIDTHS = (8, 16, 32)


def n_ops(width: int) -> int:
    """Source operations per element per iteration, counted as
    ``bench.py`` counts them (:278): the width's xors and adds, the half
    width of v sums, the two accumulator chains and the final xor."""
    return width + width // 2 + (width // 2 - 2) + 1


def check_args(x: torch.Tensor, iters: int, width: int) -> None:
    if x.dtype != torch.int32:
        raise ValueError(f"x must hold uint32 bit patterns as int32, got "
                         f"{x.dtype}")
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}, got {width}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def alu_peak_ref(x: torch.Tensor, iters: int, width: int = 32) -> torch.Tensor:
    """`iters` iterations of the probe's DAG on every element of `x` (int32
    bit patterns of uint32 values); returns ``a ^ b`` in the same form."""
    check_args(x, iters, width)
    h = width // 2
    a = x.to(torch.int64) & MASK
    b = a ^ B0
    for _ in range(iters):
        vs = [((a ^ (T0 + i)) + ((b + U0 + i) & MASK)) & MASK
              for i in range(h)]
        acc1, acc2 = vs[0], vs[h // 2]
        for v in vs[1 : h // 2]:
            acc1 = acc1 ^ v
        for v in vs[h // 2 + 1 :]:
            acc2 = (acc2 + v) & MASK
        a, b = acc1, acc2
    out = a ^ b
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)
