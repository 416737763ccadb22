"""The integer peak probe's plain version (ops/alu_peak_torch.py) against a
numpy uint32 model and against the TPU kernel itself: the Pallas
microkernel of ``bench.py::_kernel_bench`` (:250-276), rebuilt here from
its body (the bench's closure cannot be imported) and run with
``interpret=True``. Inputs come from numpy seeds; every comparison is
exact (the probe is integer arithmetic mod 2^32). The kernel bench's SASS
loop count and its exit without a card are checked too."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ntlink_tpu_torch.ops import alu_peak_cuda
from ntlink_tpu_torch.ops.alu_peak_torch import WIDTHS, alu_peak_ref, n_ops

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _numpy_probe(x: np.ndarray, iters: int, width: int) -> np.ndarray:
    h = width // 2
    a = x.astype(np.uint32)
    b = a ^ np.uint32(0xDEADBEEF)
    with np.errstate(over="ignore"):
        for _ in range(iters):
            vs = [(a ^ np.uint32(0x9E3779B1 + i))
                  + (b + np.uint32(0x85EBCA6B + i)) for i in range(h)]
            acc1 = vs[0]
            for v in vs[1 : h // 2]:
                acc1 = acc1 ^ v
            acc2 = vs[h // 2]
            for v in vs[h // 2 + 1 :]:
                acc2 = acc2 + v
            a, b = acc1, acc2
    return a ^ b


def _pallas_probe(x: np.ndarray, iters: int, width: int) -> np.ndarray:
    """bench.py:250-276 at a given width, interpreted on the CPU."""

    def kern(x_ref, o_ref):
        a = x_ref[:, :]
        b = a ^ jnp.uint32(0xDEADBEEF)

        def body(_, carry):
            a, b = carry
            ts = [a ^ jnp.uint32(0x9E3779B1 + i) for i in range(width // 2)]
            us = [b + jnp.uint32(0x85EBCA6B + i) for i in range(width // 2)]
            vs = [t + u for t, u in zip(ts, us)]
            acc1 = vs[0]
            for v in vs[1 : len(vs) // 2]:
                acc1 = acc1 ^ v
            acc2 = vs[len(vs) // 2]
            for v in vs[len(vs) // 2 + 1 :]:
                acc2 = acc2 + v
            return acc1, acc2

        a, b = jax.lax.fori_loop(0, iters, body, (a, b))
        o_ref[:, :] = a ^ b

    call = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.uint32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(x)))


def _input(seed: int, shape=(8, 128)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    x[0, :4] = [0, 0xFFFFFFFF, 0xDEADBEEF, 0x80000000]
    return x


def _torch_probe(x: np.ndarray, iters: int, width: int) -> np.ndarray:
    out = alu_peak_cuda.alu_peak(torch.from_numpy(x.view(np.int32)), iters,
                                 width)
    return out.numpy().view(np.uint32)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("iters", [0, 1, 5, 64])
def test_plain_version_matches_numpy(iters, width):
    x = _input(iters * 100 + width)
    assert np.array_equal(_torch_probe(x, iters, width),
                          _numpy_probe(x, iters, width))


@pytest.mark.parametrize("width", WIDTHS)
def test_plain_version_matches_pallas_kernel(width):
    for iters in (1, 5, 64):
        x = _input(iters + width)
        assert np.array_equal(_torch_probe(x, iters, width),
                              _pallas_probe(x, iters, width)), iters


def test_counts_and_arguments():
    # bench.py:278 counts 63 source ops per element per iteration at 32
    assert n_ops(32) == 63
    assert [n_ops(w) for w in (8, 16)] == [15, 31]
    x = torch.zeros(4, dtype=torch.int32)
    launches = alu_peak_cuda.launches
    alu_peak_cuda.alu_peak(x, 3, 8)  # CPU: the plain version, no launch
    assert alu_peak_cuda.launches == launches
    with pytest.raises(ValueError):
        alu_peak_ref(x, 1, 12)
    with pytest.raises(ValueError):
        alu_peak_ref(x.to(torch.int64), 1, 8)


# the width-8 probe's SASS on sm_90a (cuobjdump -sass, encodings dropped):
# a forward branch past the loop, then the loop from 0x0120 to its back edge
SASS_W8 = """
        /*00e0*/                   LOP3.LUT R7, R0, 0xdeadbeef, RZ, 0x3c, !PT ;
        /*00f0*/              @!P0 BRA 0x1f0 ;
        /*0100*/                   LOP3.LUT R7, R0, 0xdeadbeef, RZ, 0x3c, !PT ;
        /*0110*/                   UMOV UR4, URZ ;
        /*0120*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*0130*/                   LOP3.LUT R6, R0.reuse, 0x9e3779b4, RZ, 0x3c, !PT ;
        /*0140*/                   LOP3.LUT R2, R0.reuse, 0x9e3779b1, RZ, 0x3c, !PT ;
        /*0150*/                   LOP3.LUT R4, R0, 0x9e3779b2, RZ, 0x3c, !PT ;
        /*0160*/                   ISETP.LE.AND P0, PT, R8, UR4, PT ;
        /*0170*/                   LOP3.LUT R0, R0, 0x9e3779b3, RZ, 0x3c, !PT ;
        /*0180*/                   IADD3 R9, R6, -0x7a143592, R7 ;
        /*0190*/                   IADD3 R0, R0, -0x7a143593, R7.reuse ;
        /*01a0*/                   IADD3 R2, R2, -0x7a143595, R7.reuse ;
        /*01b0*/                   IADD3 R3, R4, -0x7a143594, R7 ;
        /*01c0*/                   IMAD.IADD R7, R0, 0x1, R9 ;
        /*01d0*/                   LOP3.LUT R0, R3, R2, RZ, 0x3c, !PT ;
        /*01e0*/              @!P0 BRA 0x120 ;
        /*01f0*/                   ULDC.64 UR4, c[0x0][0x218] ;
        /*0250*/                   EXIT ;
        /*0260*/                   BRA 0x260;
        /*0270*/                   NOP;
"""


def test_kernel_bench_counts_one_loop_iteration():
    from ntlink_tpu_torch.kernel_bench import loop_body

    body = loop_body(SASS_W8)
    assert body[0] == "UIADD3" and body[-1] == "BRA"
    assert len(body) == 13
    assert sum(op.startswith("LOP3") for op in body) == 5
    assert sum(op == "IADD3" for op in body) == 4


def test_kernel_bench_without_cuda_exits_nonzero(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "ntlink_tpu_torch.kernel_bench"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert res.returncode != 0
    assert res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr
