"""Kernel measurements on one CUDA card, the port's ``bench._kernel_bench``.

    python -m ntlink_tpu_torch.kernel_bench

Prints one JSON line and exits 0 when every kernel agreed with its plain
version, non-zero otherwise and without a CUDA device. It reports:

- ``sketch_cuda_gbase_per_s``: the sketch kernel (``csrc/sketch.cu``) at
  bench.py's B = 2048 x L = 16384 (:167), and
  ``sketch_cuda_chunked_gbase_per_s`` at 512 x 65536 (:311), each timed by
  the difference of two chains of back-to-back launches (9 and 65, 5 and
  21, as bench.py's `make_chain`), CUDA events, best of 3: the launch and
  allocation cost cancels;
- ``sketch_equals_plain_on_card``: the kernel against
  `sketch_torch.sketch_rows_ref` on the valid columns at 2048 x 16384 and
  at 8 x 32768 (bench.py :345), in place of the Pallas == XLA checks;
- ``int32_demonstrated_peak_gops`` for widths 8, 16 and 32 and the best
  width: the integer peak probe (``csrc/alu_peak.cu``, the counterpart of
  bench.py's Pallas microkernel) on (256, 1024) elements, per iteration
  (t(40,960) - t(8,192)) / 32,768, best of 3 per length, times the source
  operations per element per iteration (63 at width 32, bench.py :278);
- ``int32_sass_instr_per_iter``: the instructions of the probe's loop body
  in the built library (``cuobjdump -sass``), and the rate of those
  (``int32_sass_ginstr_per_s``, per thread): nvcc fuses xor and add chains
  into LOP3 and IADD3, so the two rates differ.

Not ported: ``sketch_ops_per_base``, ``sketch_effective_gops``,
``sketch_vpu_util_pct`` and ``kernel_ops_per_base``. They count the TPU
kernel's vector operations against the TPU's VPU peak. A utilization of
the sketch kernel on this card needs a count of the work that reads the
same whatever implements it; that waits for the benchmark that defines the
roofline.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from collections import Counter

import numpy as np
import torch

from .ops import alu_peak_cuda, build, sketch_cuda
from .ops.alu_peak_torch import WIDTHS, alu_peak_ref, n_ops
from .ops.sketch_torch import sketch_rows_ref

K, W = 32, 100                           # bench.py:42
SKETCH_SHAPE, SKETCH_CHAIN = (2048, 16384), (9, 65)
CHUNKED_SHAPE, CHUNKED_CHAIN = (512, 65536), (5, 21)
CHECK_SHAPES = ((2048, 16384), (8, 32768))
PROBE_SHAPE = (256, 1024)
PROBE_ITERS = (8192, 40960)
SEED = 7


def best_ms(fn, reps: int = 3) -> float:
    """Best of `reps` CUDA-event timings of `fn`, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def per_step_ms(step, counts) -> float:
    """Milliseconds of one `step(n)` unit by difference: (t(n_long) -
    t(n_short)) / (n_long - n_short)."""
    short, long_ = counts
    t = {n: best_ms(lambda n=n: step(n)) for n in counts}
    return max(t[long_] - t[short], 1e-9) / (long_ - short)


def random_rows(dev, rng, B: int, L: int):
    codes = torch.from_numpy(rng.integers(0, 4, (B, L), dtype=np.uint8))
    return codes.to(dev), torch.full((B,), L, dtype=torch.int32, device=dev)


def sketch_gbase_per_s(dev, rng, shape, chain) -> float:
    codes, lengths = random_rows(dev, rng, *shape)

    def launches(n):
        for _ in range(n):
            sketch_cuda.sketch_rows(codes, lengths, K, W)

    return shape[0] * shape[1] / per_step_ms(launches, chain) / 1e6


def sketch_equals_plain(dev, rng, shape) -> bool:
    """Kernel == plain version on the valid columns (hash, strand) and on
    every window (winner, emit)."""
    codes, lengths = random_rows(dev, rng, *shape)
    out = sketch_cuda.sketch_rows(codes, lengths, K, W)
    ref = sketch_rows_ref(codes, lengths, K, W)
    M = shape[1] - K + 1
    return all(torch.equal(a[:, :M], b[:, :M]) for a, b in zip(out[:2], ref[:2])
               ) and all(torch.equal(a, b) for a, b in zip(out[2:], ref[2:]))


def probe_input(dev, rng, shape=PROBE_SHAPE) -> torch.Tensor:
    x = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(dev)


def alu_peak_seconds_per_iter(x: torch.Tensor, width: int) -> float:
    """Seconds of one probe iteration over all of `x`, by difference of
    two launch lengths (one launch each)."""
    return per_step_ms(lambda n: alu_peak_cuda.alu_peak(x, n, width),
                       PROBE_ITERS) / 1e3


def cuobjdump_path() -> str:
    path = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.access(path, os.X_OK):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({path})")
    return path


_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(
    r"BRA(?:\.\w+)*\s+(?:!?U?P\w+\s*,\s*)?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))"
)


def loop_body(sass: str):
    """Opcodes of the loop body (label to back edge) of one function's
    SASS, NOPs left out; the longest loop if there are several."""
    instrs, labels, pending = [], {}, []
    for line in sass.splitlines():
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        instrs.append((addr, m.group(2)))
    best = []
    for addr, text in instrs:
        m = _TARGET.search(text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target <= addr:
            body = [t for a, t in instrs if target <= a <= addr]
            if len(body) > len(best):
                best = body
    ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in best]
    return [op for op in ops if not op.startswith("NOP")]


def alu_peak_sass() -> dict:
    """{width: opcodes of the probe's loop body} from the built library."""
    lib = build.build("alu_peak")
    text = subprocess.run([cuobjdump_path(), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    funcs = {}
    parts = _FUNC.split(text)
    for name, body in zip(parts[1::2], parts[2::2]):
        m = re.search(r"alu_peak_kernelILi(\d+)E", name)
        if m:
            funcs[int(m.group(1))] = loop_body(body)
    missing = [w for w in WIDTHS if not funcs.get(w)]
    if missing:
        raise RuntimeError(f"no loop found in the SASS of widths {missing}")
    return funcs


def alu_peak_rates(dev, rng) -> dict:
    """The probe's rates per width: source GOPS and SASS G instr/s."""
    x = probe_input(dev, rng)
    sass = alu_peak_sass()
    out = {"gops": {}, "sass_ginstr": {}, "sass_instr": {}, "sass_ops": {},
           "ms_per_iter": {}}
    for width in WIDTHS:
        s = alu_peak_seconds_per_iter(x, width)
        out["ms_per_iter"][width] = s * 1e3
        out["gops"][width] = n_ops(width) * x.numel() / s / 1e9
        out["sass_instr"][width] = len(sass[width])
        out["sass_ginstr"][width] = len(sass[width]) * x.numel() / s / 1e9
        out["sass_ops"][width] = dict(Counter(
            op.split(".")[0] for op in sass[width]
        ).most_common())
    return out


def alu_peak_equals_plain(dev, rng, iters=7) -> bool:
    x = probe_input(dev, rng, (8, 1024))
    return all(
        torch.equal(alu_peak_cuda.alu_peak(x, iters, wd),
                    alu_peak_ref(x, iters, wd))
        for wd in WIDTHS
    )


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def run(dev) -> dict:
    """Every measurement of the module on `dev`, as one JSON-ready dict."""
    rng = np.random.default_rng(SEED)
    out = {"device": torch.cuda.get_device_name(dev),
           "nvidia_smi": nvidia_smi(), "k": K, "w": W}
    out["sketch_cuda_gbase_per_s"] = sketch_gbase_per_s(
        dev, rng, SKETCH_SHAPE, SKETCH_CHAIN)
    out["sketch_cuda_chunked_gbase_per_s"] = sketch_gbase_per_s(
        dev, rng, CHUNKED_SHAPE, CHUNKED_CHAIN)
    checks = {f"{B}x{L}": sketch_equals_plain(dev, rng, (B, L))
              for B, L in CHECK_SHAPES}
    out["sketch_equals_plain_on_card"] = all(checks.values())
    out["sketch_equals_plain_by_shape"] = checks
    out["alu_peak_equals_plain_on_card"] = alu_peak_equals_plain(dev, rng)
    rates = alu_peak_rates(dev, rng)
    best = max(WIDTHS, key=lambda wd: rates["gops"][wd])
    out["int32_demonstrated_peak_gops"] = rates["gops"]
    out["int32_best_width"] = best
    out["int32_peak_gops"] = rates["gops"][best]
    out["int32_sass_instr_per_iter"] = rates["sass_instr"]
    out["int32_sass_ginstr_per_s"] = rates["sass_ginstr"]
    out["int32_sass_loop_opcodes"] = rates["sass_ops"]
    out["int32_ms_per_iter"] = rates["ms_per_iter"]
    out["probe_shape"] = list(PROBE_SHAPE)
    out["probe_iters"] = list(PROBE_ITERS)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_bench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    out = run(torch.device("cuda", 0))
    print(json.dumps(out))
    ok = out["sketch_equals_plain_on_card"] and out[
        "alu_peak_equals_plain_on_card"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
