"""Sketch math of the port (ntlink_tpu_torch.ops) against the JAX package.

`sketch_rows_ref` is the plain version of the Hopper kernel; here it is held
bit for bit against both Pallas kernels in interpret mode and against the
NumPy ground truth. All outputs are integers, so every comparison is exact.
"""
import numpy as np
import pytest
import torch

from ntlink_tpu.ops import nthash_np
from ntlink_tpu.ops.sketch_jax import finish_hash as jax_finish_hash
from ntlink_tpu.ops.sketch_pallas import (
    ROWS,
    sketch_batch_pallas,
    sketch_batch_pallas_chunked,
)
from ntlink_tpu_torch.ops import sketch_cuda, sketch_torch as st

EDGE = [0, 1, 2**63 - 1, 2**63, 2**64 - 1]


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _i64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def _edge_lengths(rng, k, w, B, L):
    lengths = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    lengths[0] = k + w - 2
    lengths[1] = max(k - 1, 1)
    lengths[2] = 0
    lengths[3] = k + w - 1
    return lengths


def _check_against_pallas(codes, lengths, k, w, pallas_out):
    can_hi, can_lo, fwd_p, win_p, emit_p = (np.asarray(o) for o in pallas_out)
    can, fwd, winner, emit = st.sketch_rows_ref(
        torch.from_numpy(codes.astype(np.uint8)), torch.from_numpy(lengths),
        k, w,
    )
    can_p = (can_hi.astype(np.uint64) << np.uint64(32)) | can_lo
    for r in range(codes.shape[0]):
        valid = max(int(lengths[r]) - k + 1, 0)  # columns [0, len-k]
        assert np.array_equal(_u64(can)[r, :valid], can_p[r, :valid]), r
        assert np.array_equal(fwd.numpy()[r, :valid], fwd_p[r, :valid]), r
    assert np.array_equal(winner.numpy(), win_p)
    assert np.array_equal(emit.numpy(), emit_p.astype(bool))
    # and the NumPy ground truth, after finish_hash
    out = _u64(st.finish_hash(can, k))
    for r in range(codes.shape[0]):
        ref = nthash_np.sketch_codes(codes[r, : lengths[r]], k, w)
        sel = winner[r][emit[r]].numpy()
        assert np.array_equal(sel, ref.positions), r
        assert np.array_equal(out[r][sel], ref.hashes), r
        assert np.array_equal(fwd[r].numpy()[sel], ref.forward), r


@pytest.mark.parametrize(
    "k,w", [(32, 100), (20, 10), (15, 5), (40, 100), (24, 250), (17, 8)]
)
def test_ref_matches_pallas_and_numpy(k, w):
    rng = np.random.default_rng(k + w)
    B, L = ROWS, 2048
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lengths = _edge_lengths(rng, k, w, B, L)
    _check_against_pallas(
        codes, lengths, k, w, sketch_batch_pallas(codes, lengths, k, w, True)
    )


@pytest.mark.parametrize("k,w", [(32, 100), (24, 250), (15, 5)])
def test_ref_matches_pallas_chunked(k, w):
    """The chunked TPU kernel (chunk=512 forces seams) is the same contract:
    the port has one kernel for every pad."""
    rng = np.random.default_rng(3 * k + w)
    B, L = ROWS, 4096
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lengths = rng.integers(L // 2, L + 1, size=B).astype(np.int32)
    lengths[0] = k + w - 2
    lengths[1] = 0
    out = sketch_batch_pallas_chunked(
        codes.astype(np.int32), lengths, k, w, 512, True
    )
    _check_against_pallas(codes, lengths, k, w, out)


def test_tied_keys_take_leftmost():
    """Rows of one repeated base: every key of a row ties, so each window's
    winner must be its leftmost column, across the whole row."""
    k, w = 15, 5
    L = 2048
    codes = np.zeros((ROWS, L), np.uint8)
    codes[1] = 2
    codes[2, ::2] = 1
    lengths = np.full(ROWS, L, np.int32)
    _check_against_pallas(
        codes, lengths, k, w, sketch_batch_pallas(codes, lengths, k, w, True)
    )


def test_finish_hash_matches_jax():
    rng = np.random.default_rng(9)
    vals = np.concatenate([
        rng.integers(0, 2**64 - 1, 4096, dtype=np.uint64, endpoint=True),
        np.array(EDGE, np.uint64),
    ])
    for k in (15, 24, 32, 40):
        hi, lo = jax_finish_hash(
            (vals >> np.uint64(32)).astype(np.uint32),
            (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32), k,
        )
        want = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
            lo
        )
        assert np.array_equal(_u64(st.finish_hash(_i64(vals), k)), want), k


def test_int64_helpers_match_uint64():
    rng = np.random.default_rng(10)
    a = np.concatenate([
        rng.integers(0, 2**64 - 1, 2000, dtype=np.uint64, endpoint=True),
        np.repeat(np.array(EDGE, np.uint64), len(EDGE)),
    ])
    b = np.concatenate([
        rng.integers(0, 2**64 - 1, 2000, dtype=np.uint64, endpoint=True),
        np.tile(np.array(EDGE, np.uint64), len(EDGE)),
    ])
    ta, tb = _i64(a), _i64(b)
    assert np.array_equal(st.u64_lt(ta, tb).numpy(), a < b)
    with np.errstate(over="ignore"):
        # int64 add and multiply wrap exactly as uint64 does
        assert np.array_equal(_u64(ta + tb), a + b)
        assert np.array_equal(_u64(ta * tb), a * b)
    for n in (0, 1, 27, 32, 33, 63):
        assert np.array_equal(_u64(st.shr(ta, n)), a >> np.uint64(n)), n
    for d in (0, 1, 5, 31, 32, 33, 40, 63, 100):
        assert np.array_equal(_u64(st.srol(ta, d)), nthash_np.srol(a, d)), d
    for v in EDGE:
        assert st.to_i64(v) == np.array([v], np.uint64).view(np.int64)[0]


def test_cpu_tensor_takes_plain_version():
    from ntlink_tpu_torch.ops import build  # imports without nvcc

    assert build.BUILD_DIR.endswith("_build")
    rng = np.random.default_rng(2)
    codes = torch.from_numpy(rng.integers(0, 4, (4, 1024), dtype=np.uint8))
    lengths = torch.tensor([1024, 900, 0, 131], dtype=torch.int32)
    sketch_cuda.launches = 0
    got = sketch_cuda.sketch_rows(codes, lengths, 32, 100)
    want = st.sketch_rows_ref(codes, lengths, 32, 100)
    assert sketch_cuda.launches == 0
    assert sketch_cuda._lib is None  # nothing was built or loaded
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.parametrize(
    "codes,lengths",
    [
        (torch.zeros((2, 1024), dtype=torch.int32),
         torch.zeros(2, dtype=torch.int32)),
        (torch.zeros((2, 1024), dtype=torch.uint8),
         torch.zeros(2, dtype=torch.int64)),
        (torch.zeros((2, 1024), dtype=torch.uint8),
         torch.zeros(3, dtype=torch.int32)),
        (torch.zeros((1024, 2), dtype=torch.uint8).t(),
         torch.zeros(2, dtype=torch.int32)),
    ],
)
def test_wrapper_rejects_bad_inputs(codes, lengths):
    with pytest.raises(ValueError):
        sketch_cuda.sketch_rows(codes, lengths, 32, 100)

