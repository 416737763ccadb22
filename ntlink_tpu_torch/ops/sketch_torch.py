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

from . import nthash_np

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


@functools.lru_cache(maxsize=None)
def _byte_tables(k: int):
    """(fwd, rev) lists of ceil(k/4) 256-entry int64 tables: table j maps
    the byte of bases 4j..4j+3 of a k-mer (base 4j+t in bits 2t) to the XOR
    of those bases' srol terms; bases past k-1 do not count."""
    out = []
    for tab in _tables(k):
        groups = []
        for j in range(0, k, 4):
            n = min(4, k - j)
            row = []
            for code in range(256):
                v = 0
                for t in range(n):
                    v ^= tab[j + t][(code >> (2 * t)) & 3]
                row.append(v)
            groups.append(row)
        out.append(groups)
    return out


def kmer_hashes(codes: torch.Tensor, k: int):
    """Forward and reverse-complement ntHash2 of the k-mer starting at
    every column: (fh, rh) (B, L) int64, right on columns [0, L-k]; the
    columns past L-k are 0. Four bases at a time: one byte per column and
    one 256-entry table lookup per 4 bases of the k-mer."""
    B, L = codes.shape
    M = L - k + 1
    fh = torch.zeros((B, L), dtype=torch.int64, device=codes.device)
    rh = torch.zeros_like(fh)
    if M <= 0:
        return fh, rh
    c = torch.cat([
        codes.to(torch.int64),
        torch.zeros((B, 3), dtype=torch.int64, device=codes.device),
    ], dim=1)
    byte = c[:, :L] | (c[:, 1 : L + 1] << 2) | (c[:, 2 : L + 2] << 4) | (
        c[:, 3 : L + 3] << 6
    )
    fwd_tabs, rev_tabs = (
        torch.tensor(t, dtype=torch.int64, device=codes.device)
        for t in _byte_tables(k)
    )
    for j in range(fwd_tabs.shape[0]):
        bj = byte[:, 4 * j : 4 * j + M]
        fh[:, :M] ^= fwd_tabs[j][bj]
        rh[:, :M] ^= rev_tabs[j][bj]
    return fh, rh


def _shift_left(x: torch.Tensor, o: int, fill: int) -> torch.Tensor:
    """x[:, i] <- x[:, i+o], tail filled."""
    o = min(o, x.shape[1])
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
    L = codes.shape[1]
    fh, rh = kmer_hashes(codes, k)
    can = fh + rh  # wraps mod 2^64
    fwd = ~u64_lt(rh, fh)
    lengths = lengths.to(torch.int64)
    invalid = (
        torch.arange(L, device=codes.device)[None, :]
        > (lengths - k)[:, None]
    )
    winner, emit = _windows(
        torch.where(invalid, ALL_ONES, can)[:, : max(L - k + 1, 0)],
        lengths - k + 1, w,
    )
    return can, fwd, winner.to(torch.int32), emit


def _windows(key: torch.Tensor, n_kmers: torch.Tensor, w: int):
    """Leftmost argmin of each w-window of the (B, M) uint64 k-mer keys
    (int64 bit patterns) and the emit mask: the winner differs from the
    previous window's, the window lies inside the row's first `n_kmers`
    keys and its key's high half is not all ones. Returns (winner (B, NW)
    int64, emit (B, NW) bool), NW = max(M-w+1, 0)."""
    B, L = key.shape
    dev = key.device
    NW = max(L - w + 1, 0)
    # signed view of the unsigned key order: flip the sign bit once
    key = key ^ SIGN
    idx = torch.arange(L, device=dev).expand(B, L)
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
    n_win = torch.clamp(n_kmers - w + 1, min=0)
    wpos = torch.arange(NW, device=dev)
    emit = (
        (winner != prev)
        & (wpos[None, :] < n_win[:, None])
        & (shr(win_key, 32) != 0xFFFFFFFF)
    )
    return winner, emit


def compact_windows(can: torch.Tensor, nmask: torch.Tensor,
                    lengths: torch.Tensor, k: int, w: int):
    """Windows of rows with non-ACGT bases (``sketch_batch_kernel(...,
    compact_invalid=True)``, sketch_jax.py:247-336): minimizer windows run
    over the sequence of valid k-mers, spanning N gaps, and a valid stretch
    shorter than w emits nothing.

    can: (B, L) int64 canonical hashes, right on every k-mer that covers no
    non-ACGT base (the sketch kernel's plane over the rows with N cleaned
    to A); nmask: (B, L) bool, True at non-ACGT bases; lengths: (B,).
    Returns (winner (B, NW) int32 original columns, emit (B, NW) bool),
    NW = max(L-k-w+2, 0). A stable partition moves the valid k-mers to the
    row front (cumsum + scatter), the window minimum runs over that
    compacted row, and the winners map back to their columns."""
    B, L = can.shape
    dev = can.device
    pos = torch.arange(L, device=dev)
    # k-mers covering a non-ACGT base: N count in [p, p+k) from a cumsum
    cs = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int64, device=dev),
         nmask.to(torch.int64).cumsum(dim=1)], dim=1,
    )
    ends = (pos + k).clamp(max=L).expand(B, L)
    bad = cs.gather(1, ends) - cs[:, :L] > 0
    invalid = bad | (pos[None, :] > (lengths.to(torch.int64) - k)[:, None])
    valid = ~invalid
    n_kmers = valid.sum(dim=1)
    tgt = torch.where(
        valid,
        valid.to(torch.int64).cumsum(dim=1) - 1,
        invalid.to(torch.int64).cumsum(dim=1) - 1 + n_kmers[:, None],
    )
    key = torch.empty_like(can).scatter_(
        1, tgt, torch.where(invalid, ALL_ONES, can)
    )
    valid_idx = torch.empty((B, L), dtype=torch.int64, device=dev).scatter_(
        1, tgt, pos.expand(B, L)
    )
    winner, emit = _windows(key[:, : max(L - k + 1, 0)], n_kmers, w)
    return valid_idx.gather(1, winner).to(torch.int32), emit
