"""The Hopper sketch kernel and integer peak probe against their plain
versions, and the steps of N batches against the CPU's, on the card.

This file imports no JAX (nor does anything it imports), so it also runs on
a machine without JAX, where ``tests/conftest.py`` cannot load:

    python3 -m pytest --noconftest -q tests/torch_port/test_torch_cuda.py

Without a CUDA device every test here skips.
"""
import numpy as np
import pytest
import torch

from ntlink_tpu_torch.ops import alu_peak_cuda, sketch_cuda, sketch_torch as st
from ntlink_tpu_torch.ops.alu_peak_torch import WIDTHS, alu_peak_ref


def _edge_lengths(rng, k, w, B, L):
    """B row lengths, the first of them at the edges: no window, no k-mer,
    empty, one window, the full pad."""
    lengths = rng.integers(L // 2, L + 1, size=max(B, 5)).astype(np.int32)
    lengths[:5] = [k + w - 2, k - 1, 0, k + w - 1, L]
    return lengths[:B]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,w,L", [(32, 100, 16384), (15, 5, 32768), (40, 100, 1 << 21),
              (24, 250, 5000)]
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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sketch", "anchors", "runs"])
def test_steps_with_n_rows_on_card_match_cpu(mode):
    """The sketch step and the mapping step (chained, per-anchor and
    runs) on an N batch: the card's payload equals the CPU's (plain
    version) bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ntlink_tpu_torch import mapping_step as ms
    from ntlink_tpu_torch.index import ContigIndex
    from ntlink_tpu_torch.ops import nthash_np
    from ntlink_tpu_torch.stream_pipeline import split_n_rows

    k, w, L, B = 32, 100, 16384, 16
    rng = np.random.default_rng(7)
    contigs = [rng.integers(0, 4, 200_000).astype(np.uint8) for _ in range(3)]
    rows, lengths = [], _edge_lengths(rng, k, w, B, L)
    for r in range(B):
        s = int(rng.integers(0, 200_000 - L))
        read = contigs[r % 3][s : s + int(lengths[r])].copy()
        if len(read):
            read[rng.integers(0, len(read), 3 * (r % 4))] = 4
        rows.append(read)
    clean, nmask = split_n_rows(rows, B, L)
    codes = np.zeros((B, L), np.uint8)
    for r, c in enumerate(clean):
        codes[r, : len(c)] = c
    args = [torch.from_numpy(ms.pack_codes(codes)),
            torch.from_numpy(lengths), torch.from_numpy(nmask)]
    outs = []
    for dev in ("cpu", "cuda"):
        packed, lens, nm = (a.to(dev) for a in args)
        if mode == "sketch":
            out = ms.sketch_step(packed, lens, k, w, L, 1024, nmask=nm)
        else:
            index = ContigIndex.from_sketches(
                (f"c{i}", nthash_np.sketch_codes(c, k, w))
                for i, c in enumerate(contigs)
            )
            out = ms.mapping_step(
                packed, lens, ms.DeviceIndex.from_contig_index(index, dev),
                k, w, L, 1024, nmask=nm,
                clen=torch.full((3,), 200_000, dtype=torch.int32,
                                device=dev),
                z=1000, runs=mode == "runs",
            )
        outs.append(out.cpu())
    assert torch.equal(outs[0], outs[1])
    assert int(outs[0][:B].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDTHS)
def test_alu_peak_matches_plain_version_on_card(width):
    """The probe kernel equals its plain version bit for bit (uint32 math
    mod 2^32) at the probe's (256, 1024) shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(width)
    x = rng.integers(0, 2**32, (256, 1024), dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(x.view(np.int32)).cuda()
    for iters in (0, 1, 7, 64):
        launches = alu_peak_cuda.launches
        out = alu_peak_cuda.alu_peak(x, iters, width)
        assert alu_peak_cuda.launches == launches + 1
        assert torch.equal(out, alu_peak_ref(x, iters, width)), iters
