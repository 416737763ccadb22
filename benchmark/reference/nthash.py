"""Plain NumPy (k, w) minimizer sketch: ntHash2's canonical hash and the
leftmost minimum of every window of w valid k-mers.

The semantics are those of btllib's indexlr as ntLink runs it:

- base seeds S[b] for A, C, G, T; N (code 4) contributes nothing and makes
  every k-mer over it invalid;
- the split rotation P rotates bits 33..63 (31 bits) and bits 0..32
  (33 bits) of a 64-bit word left by one, each field on its own;
- forward hash fh(i) = XOR_j P^(k-1-j)(S[c(i+j)]), reverse hash
  rh(i) = XOR_j P^j(S[3 - c(i+j)]), canonical key fh + rh (mod 2^64),
  strand '+' iff fh <= rh, reported hash t ^ (t >> 27) with
  t = key * (1 ^ (k * 0x90b45d39fb6da1fa));
- windows run over the list of valid k-mers; each window's leftmost
  minimum is selected, and a position selected by consecutive windows is
  reported once.

The hashes come from prefix XORs: with A(t) = P^-t(S[c(t)]) and
G(t) = A(0) ^ ... ^ A(t-1), fh(i) = P^(i+k-1)(G(i+k) ^ G(i)); rh likewise
with P^t and P^-i. P^d is a rotation of each field by d mod 31 and
d mod 33, so every step is a whole-array NumPy operation. The window
minimum is van Herk's: a prefix and a suffix minimum inside blocks of w
keys, with the leftmost argmin carried by record positions.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

U64 = np.uint64
SEEDS = np.array(
    [0x3C8BFBB395C60474, 0x3193C18562A02B4C, 0x20323ED082572324,
     0x295549F54BE24456], dtype=np.uint64)
MULTISEED = 0x90B45D39FB6DA1FA
MULTISHIFT = 27
M31 = U64((1 << 31) - 1)
M33 = U64((1 << 33) - 1)

#: ASCII -> code (0..3 = ACGT either case, 4 = anything else)
ASCII_CODES = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    ASCII_CODES[ord(_c)] = _i
    ASCII_CODES[ord(_c.lower())] = _i


PERIOD = 31 * 33   # P^d repeats every 1023 steps in both fields
CHUNK = PERIOD * 256


def _rot(x: np.ndarray, d, bits: int, mask) -> np.ndarray:
    """Rotate each `bits`-wide value of `x` left by `d` (0 <= d < bits)."""
    d = np.asarray(d, dtype=np.uint64)
    return ((x << d) | (x >> (U64(bits) - d))) & mask


def _srol(x: np.ndarray, d: np.ndarray) -> np.ndarray:
    """P^d of packed words, d >= 0 (elementwise or scalar)."""
    return ((_rot(x >> U64(33), d % 31, 31, M31) << U64(33))
            | _rot(x & M33, d % 33, 33, M33))


def _table(seeds: np.ndarray, sign: int) -> np.ndarray:
    """[code * PERIOD + r] = P^(sign * r)(seeds[code]); code 4 (N) is 0."""
    tab = np.zeros((5, PERIOD), dtype=np.uint64)
    r = np.arange(PERIOD, dtype=np.int64)
    for b in range(4):
        tab[b] = _srol(np.full(PERIOD, seeds[b]), (sign * r) % PERIOD)
    return tab.ravel()


_FWD = _table(SEEDS, -1)          # A(t) = P^-t(S[c(t)])
_REV = _table(SEEDS[::-1], +1)    # B(t) = P^t(S[3 - c(t)])
_COL = (np.arange(CHUNK + 4096) % PERIOD).astype(np.int32)


def _powers(d: np.ndarray):
    """P^d as multipliers: 2^(d mod 31) for the 31-bit field, and
    2^(d mod 33) split in two factors of at most 2^16 for the 33-bit field,
    so that no product passes 64 bits."""
    a = d % 31
    b = d % 33
    b1 = np.minimum(b, 16)
    one = U64(1)
    return (one << a.astype(np.uint64), one << b1.astype(np.uint64),
            one << (b - b1).astype(np.uint64))


_POWERS: dict = {}


def _powers_for(k: int):
    """Multipliers of fh (P^(i + k - 1)) and rh (P^-i) over a chunk."""
    if k not in _POWERS:
        i = np.arange(CHUNK, dtype=np.int64)
        _POWERS[k] = (_powers(i + k - 1), _powers(PERIOD - i % PERIOD))
    return _POWERS[k]


def _srol_by(x: np.ndarray, pw, m: int) -> np.ndarray:
    """P^d of packed words, with d given by `_powers` multipliers: a
    rotation of a field of `bits` bits by r is p & mask | p >> bits for
    p = x * 2^r."""
    a, b1, b2 = (v[:m] for v in pw)
    p = (x >> U64(33)) * a
    hi = (p & M31) | (p >> U64(31))
    p = (x & M33) * b1
    lo = (p & M33) | (p >> U64(33))
    p = lo * b2
    lo = (p & M33) | (p >> U64(33))
    return (hi << U64(33)) | lo


def _chunk_keys(codes: np.ndarray, k: int, m: int):
    """Keys of the first `m` k-mers of `codes` (len >= m + k - 1), whose
    first base sits at a multiple of PERIOD."""
    n = m + k - 1
    at = codes[:n].astype(np.int32)
    at *= PERIOD
    at += _COL[:n]
    g = np.bitwise_xor.accumulate(_FWD[at])
    h = np.bitwise_xor.accumulate(_REV[at])
    gd = g[k - 1:n].copy()
    gd[1:] ^= g[: m - 1]
    hd = h[k - 1:n].copy()
    hd[1:] ^= h[: m - 1]
    sf, sr = _powers_for(k)
    fh = _srol_by(gd, sf, m)
    rh = _srol_by(hd, sr, m)
    with np.errstate(over="ignore"):
        key = fh + rh
    return key, fh <= rh


def kmer_keys(codes: np.ndarray, k: int):
    """(canonical key, fh <= rh, valid) of every k-mer of `codes`."""
    n = len(codes)
    m = n - k + 1
    if m <= 0:
        z = np.zeros(0, dtype=np.uint64)
        return z, z.astype(bool), z.astype(bool)
    key = np.empty(m, dtype=np.uint64)
    fwd = np.empty(m, dtype=bool)
    for s in range(0, m, CHUNK):
        mm = min(CHUNK, m - s)
        key[s:s + mm], fwd[s:s + mm] = _chunk_keys(codes[s:s + mm + k - 1],
                                                   k, mm)
    bad = codes > 3
    if bad.any():
        csum = np.concatenate(([0], np.cumsum(bad, dtype=np.int64)))
        valid = (csum[k:] - csum[:m]) == 0
    else:
        valid = np.ones(m, dtype=bool)
    return key, fwd, valid


def out_hash(key: np.ndarray, k: int) -> np.ndarray:
    mult = U64((1 ^ (k * MULTISEED)) & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        t = key * mult
    return t ^ (t >> U64(MULTISHIFT))


def _block_winners(keys: np.ndarray, w: int, nwin: int) -> np.ndarray:
    """Leftmost argmin of the first `nwin` windows of `keys`
    (len >= nwin + w - 1), one per window."""
    m = nwin + w - 1
    nb = -(-m // w)
    kb = np.full(nb * w, np.iinfo(np.uint64).max, dtype=np.uint64)
    kb[:m] = keys[:m]
    kb = kb.reshape(nb, w)
    idx = np.arange(nb * w, dtype=np.int64).reshape(nb, w)
    # prefix minimum and its leftmost argmin: the last strict record
    pre = np.minimum.accumulate(kb, axis=1)
    strict = np.ones_like(kb, dtype=bool)
    strict[:, 1:] = kb[:, 1:] < pre[:, :-1]
    pre_arg = np.maximum.accumulate(np.where(strict, idx, -1), axis=1)
    # suffix minimum and its leftmost argmin: the next record at or after
    suf = np.minimum.accumulate(kb[:, ::-1], axis=1)[:, ::-1]
    suf_arg = np.minimum.accumulate(
        np.where(kb == suf, idx, nb * w)[:, ::-1], axis=1)[:, ::-1]
    pre, pre_arg = pre.ravel(), pre_arg.ravel()
    suf, suf_arg = suf.ravel()[:nwin], suf_arg.ravel()[:nwin]
    return np.where(suf <= pre[w - 1:w - 1 + nwin], suf_arg,
                    pre_arg[w - 1:w - 1 + nwin])


def window_winners(keys: np.ndarray, w: int, dedup: bool = True
                   ) -> np.ndarray:
    """Leftmost argmin of every window of `w` consecutive keys, ascending;
    with `dedup`, each selected position once."""
    m = len(keys)
    if m < w:
        return np.zeros(0, dtype=np.int64)
    nwin = m - w + 1
    step = w * 2048
    win = np.concatenate([s + _block_winners(keys[s:], w, min(step, nwin - s))
                          for s in range(0, nwin, step)])
    if not dedup:
        return win
    keep = np.ones(nwin, dtype=bool)
    keep[1:] = win[1:] != win[:-1]
    return win[keep]


def sketch(codes: np.ndarray, k: int, w: int):
    """(hashes uint64, positions int64, forward bool) of one sequence."""
    key, fwd, valid = kmer_keys(codes, k)
    vidx = np.nonzero(valid)[0]
    pos = vidx[window_winners(key[vidx], w)]
    return out_hash(key[pos], k), pos.astype(np.int64), fwd[pos]


def sketch_joined(seqs: Sequence[np.ndarray], k: int, w: int):
    """`sketch` of sequences without N, hashed as one joined array: a
    k-mer's hash does not depend on where it sits, so only the windows
    that lie inside one sequence are kept."""
    lens = np.array([len(x) for x in seqs], dtype=np.int64)
    offs = np.concatenate(([0], np.cumsum(lens)))
    key, fwd, _ = kmer_keys(np.concatenate(seqs), k)
    win = window_winners(key, w, dedup=False)
    seq_of = np.repeat(np.arange(len(seqs)), lens)[: len(win)]
    start = offs[:-1][seq_of]
    inside = np.arange(len(win)) - start < (lens - k - w + 2)[seq_of]
    win, seq_of = win[inside], seq_of[inside]
    keep = np.ones(len(win), dtype=bool)
    keep[1:] = win[1:] != win[:-1]
    win, seq_of = win[keep], seq_of[keep]
    cut = np.searchsorted(seq_of, np.arange(len(seqs) + 1))
    hashes = out_hash(key[win], k)
    return [(hashes[a:b], win[a:b] - offs[i], fwd[win[a:b]])
            for i, (a, b) in enumerate(zip(cut[:-1], cut[1:]))]


def sketch_many(seqs: Sequence[np.ndarray], k: int, w: int,
                threads: int = 8, group_bases: int = 1 << 23
                ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """`sketch` of every sequence, in input order: those without N joined
    in groups of about `group_bases`, over `threads` threads (the
    whole-array operations release the interpreter lock)."""
    out: list = [None] * len(seqs)
    jobs, group, size = [], [], 0
    for i, x in enumerate(seqs):
        if len(x) < k + w - 1 or (x > 3).any():
            jobs.append([i])
            continue
        group.append(i)
        size += len(x)
        if size >= group_bases:
            jobs.append(group)
            group, size = [], 0
    if group:
        jobs.append(group)

    def one(idx):
        if len(idx) == 1:
            out[idx[0]] = sketch(seqs[idx[0]], k, w)
        else:
            for i, r in zip(idx, sketch_joined([seqs[i] for i in idx], k, w)):
                out[i] = r

    jobs.sort(key=lambda idx: -sum(len(seqs[i]) for i in idx))
    if threads <= 1 or len(jobs) <= 1:
        for idx in jobs:
            one(idx)
        return out
    with ThreadPoolExecutor(max_workers=threads) as pool:
        for fut in [pool.submit(one, idx) for idx in jobs]:
            fut.result()
    return out
