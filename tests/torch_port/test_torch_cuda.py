"""The Hopper sketch kernel against its plain version, on the card.

This file imports no JAX (nor does anything it imports), so it also runs on
a machine without JAX, where ``tests/conftest.py`` cannot load:

    python3 -m pytest --noconftest -q tests/torch_port/test_torch_cuda.py

Without a CUDA device every test here skips.
"""
import numpy as np
import pytest
import torch

from ntlink_tpu_torch.ops import sketch_cuda, sketch_torch as st


def _edge_lengths(rng, k, w, B, L):
    """B row lengths, the first of them at the edges: no window, no k-mer,
    empty, one window, the full pad."""
    lengths = rng.integers(L // 2, L + 1, size=max(B, 5)).astype(np.int32)
    lengths[:5] = [k + w - 2, k - 1, 0, k + w - 1, L]
    return lengths[:B]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,w,L", [(32, 100, 16384), (15, 5, 32768), (40, 100, 1 << 21)]
)
def test_kernel_matches_plain_version_on_card(k, w, L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(L + k)
    B = 16 if L <= 32768 else 8
    codes = torch.from_numpy(rng.integers(0, 4, (B, L), dtype=np.uint8))
    lengths = torch.from_numpy(_edge_lengths(rng, k, w, B, L))
    codes, lengths = codes.cuda(), lengths.cuda()
    launches = sketch_cuda.launches
    can, fwd, winner, emit = sketch_cuda.sketch_rows(codes, lengths, k, w)
    assert sketch_cuda.launches == launches + 1
    r_can, r_fwd, r_win, r_emit = st.sketch_rows_ref(codes, lengths, k, w)
    torch.cuda.synchronize()
    valid = (
        torch.arange(L, device=codes.device)[None, :]
        <= (lengths.long() - k)[:, None]
    )
    assert torch.equal(can[valid], r_can[valid])
    assert torch.equal(fwd[valid], r_fwd[valid])
    assert torch.equal(winner, r_win)
    assert torch.equal(emit, r_emit)
