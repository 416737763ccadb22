"""ntHash2 minimizer sketch math in plain PyTorch.

Counterpart of ``ntlink_tpu/ops/sketch_jax.py`` (:48-337). PyTorch has no
usable unsigned 64-bit arithmetic on the CPU (``>>``, ``+``, ``<`` and
``minimum`` are missing for ``torch.uint64``), so every hash is held as the
int64 tensor with the same bit pattern:

- add and multiply wrap mod 2^64 in two's complement, exactly as uint64 would;
- a logical right shift is an arithmetic shift followed by a mask;
- unsigned order is signed order after flipping the sign bit.

`sketch_rows_ref` is the plain version of the hand-written Hopper kernel in
``ntlink_tpu_torch/csrc/sketch.cu`` (wrapper: ``ops/sketch_cuda.py``): same
inputs, same outputs, bit for bit. The CPU tests hold it against
``nthash_np`` and the Pallas kernels; ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import functools

import torch

from ntlink_tpu.ops import nthash_np

SIGN = -(1 << 63)            # int64 with only the sign bit set
ALL_ONES = -1                # the uint64 value 2^64-1 as int64
MULTISHIFT = nthash_np.MULTISHIFT


def to_i64(u: int) -> int:
    """uint64 value (Python int in [0, 2^64)) -> the int64 with its bits."""
    u &= 0xFFFFFFFFFFFFFFFF
    return u - (1 << 64) if u >= 1 << 63 else u


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of uint64 bit patterns held as int64."""
    if n == 0:
        return x
    if n >= 64:
        return torch.zeros_like(x)
    return (x >> n) & ((1 << (64 - n)) - 1)


def u64_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ SIGN) < (b ^ SIGN)


def srol(x: torch.Tensor, d: int) -> torch.Tensor:
    """ntHash2 split rotation applied d times (``nthash_np.srol``): bits
    33..63 rotate as a 31-bit field, bits 0..32 as a 33-bit field."""
    hi = shr(x, 33)
    lo = x & ((1 << 33) - 1)
    a, b = d % 31, d % 33
    if a:
        hi = ((hi << a) | (hi >> (31 - a))) & ((1 << 31) - 1)
    if b:
        lo = ((lo << b) | (lo >> (33 - b))) & ((1 << 33) - 1)
    return (hi << 33) | lo


@functools.lru_cache(maxsize=None)
def _tables(k: int):
    """(fwd, rev) (k, 4) srol tables as int64 lists (nthash_np.srol_tables
    without the N column)."""
    fwd, rev = nthash_np.srol_tables(k)
    return (
        [[to_i64(int(v)) for v in row[:4]] for row in fwd],
        [[to_i64(int(v)) for v in row[:4]] for row in rev],
    )


def out_multiplier(k: int) -> int:
    """``nthash_np.out_hash_multiplier`` as an int64 bit pattern."""
    return to_i64(int(nthash_np.out_hash_multiplier(k)))


def finish_hash(can: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical hash -> reported hash (ntHash second multi-hash):
    t = can * multiplier; t ^ (t >> 27). Counterpart of
    ``sketch_jax.finish_hash`` (:91-99) on one int64 plane."""
    t = can * out_multiplier(k)  # wraps mod 2^64
    return t ^ shr(t, MULTISHIFT)


def kmer_hashes(codes: torch.Tensor, k: int):
    """Forward and reverse-complement ntHash2 of the k-mer starting at
    every column: (fh, rh) (B, L) int64, right on columns [0, L-k]; the
    columns past L-k hold partial sums."""
    B, L = codes.shape
    M = L - k + 1
    fh = torch.zeros((B, L), dtype=torch.int64, device=codes.device)
    rh = torch.zeros_like(fh)
    if M <= 0:
        return fh, rh
    fwd_tab, rev_tab = (
        torch.tensor(t, dtype=torch.int64, device=codes.device)
        for t in _tables(k)
    )
    c = codes.to(torch.int64)
    for j in range(k):
        cj = c[:, j : j + M]
        fh[:, :M] ^= fwd_tab[j][cj]
        rh[:, :M] ^= rev_tab[j][cj]
    return fh, rh


def _shift_left(x: torch.Tensor, o: int, fill: int) -> torch.Tensor:
    """x[:, i] <- x[:, i+o], tail filled."""
    tail = torch.full((x.shape[0], o), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, o:], tail], dim=1)


def sketch_rows_ref(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                    w: int):
    """Plain version of the sketch kernel (the K1/K2 Pallas contract).

    codes: (B, L) integer base codes 0..3 (N-free); lengths: (B,) int32.
    Returns
      can    (B, L) int64: canonical hash fh + rh mod 2^64,
      fwd    (B, L) bool: strand, fh <= rh,
      winner (B, NW) int32: leftmost argmin of each w-window of keys,
      emit   (B, NW) bool: winner differs from the previous window's, the
             window lies inside the row and its key's high half is not
             all ones,
    with NW = max(L-k-w+2, 0). The key of column p is `can`, or all ones
    where p > len-k. `can` and `fwd` are right on columns [0, len-k].
    """
    B, L = codes.shape
    dev = codes.device
    NW = max(L - k - w + 2, 0)
    fh, rh = kmer_hashes(codes, k)
    can = fh + rh  # wraps mod 2^64
    fwd = ~u64_lt(rh, fh)
    lengths = lengths.to(torch.int64)
    pos = torch.arange(L, device=dev)
    invalid = pos[None, :] > (lengths - k)[:, None]
    # signed view of the unsigned key order: flip the sign bit once
    key = torch.where(invalid, ALL_ONES, can) ^ SIGN
    idx = pos.expand(B, L)
    top = (1 << 63) - 1  # all ones, sign-flipped
    span = 1
    while span * 2 <= w:
        s_key = _shift_left(key, span, top)
        s_idx = _shift_left(idx, span, L)
        take = s_key < key  # strict: ties keep the left (smaller) index
        key = torch.where(take, s_key, key)
        idx = torch.where(take, s_idx, idx)
        span *= 2
    o = w - span
    a_key, a_idx = key[:, :NW], idx[:, :NW]
    b_key, b_idx = key[:, o : o + NW], idx[:, o : o + NW]
    take = b_key < a_key
    winner = torch.where(take, b_idx, a_idx)
    win_key = torch.where(take, b_key, a_key) ^ SIGN
    prev = torch.cat(
        [torch.full((B, 1), -1, dtype=winner.dtype, device=dev), winner],
        dim=1,
    )[:, :NW]
    n_win = torch.clamp(lengths - k - w + 2, min=0)
    wpos = torch.arange(NW, device=dev)
    emit = (
        (winner != prev)
        & (wpos[None, :] < n_win[:, None])
        & (shr(win_key, 32) != 0xFFFFFFFF)
    )
    return can, fwd, winner.to(torch.int32), emit
