"""The fused read-mapping and sketch steps on one device, in PyTorch.

Counterpart of the single-device parts of ``ntlink_tpu/parallel/mesh.py``:
`DeviceIndex` (:61-151), `hash_bucket_join` (:234-266), `select_minimizers`
(:282-308), `compact_flat` (:311-323), `unpack_codes` / `unpack_bits`
(:326-348), `mapping_step_packed` (:570-753) without hash planes, and
`sketch_step_packed` (:756-837). One call per read batch:

    unpack codes [+ N mask] -> sketch kernel [-> windows over valid k-mers]
    -> select minimizers -> gather + finish hash -> bucket hash join
    [-> chaining acceptance [-> run summaries]] -> compact

The sketch runs through `ops.sketch_cuda.sketch_rows` (the Hopper kernel on
a CUDA device); every other stage is plain tensor code. The result is one
int32 tensor whose size depends only on the batch shape, so the caller can
start its device-to-host copy without waiting for the step:

    [count (B) | n_minimizers (B) | rposw (B*S) | cid (B*S) | cpos (B*S)]

`rposw` = rpos | cstrand << 29 | fwd << 30, and the anchor planes hold
every matched anchor packed to the front in read order (row-major), so row
r's anchors start at sum(count[:r]). A row with n_minimizers > S (the slot
budget) lost minimizers and must be remapped exactly on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .chain import RUN_LANES, chain_anchors_device, summarize_runs_device
from .ops.sketch_cuda import sketch_rows
from .ops.sketch_torch import compact_windows, finish_hash, shr

_FIB = 0x9E3779B1  # 32-bit Fibonacci hashing constant (mesh.py:29)
BUCKET = 8
BUCKET_LOAD = 4
BUCKET_LOAD_SMALL = 2
SMALL_TABLE_ENTRIES = 32_000_000


class DeviceIndex:
    """Contig-minimizer hash table on the device (mesh.DeviceIndex layout).

    `nb` (pow2) buckets of BUCKET=8 entries, one (nb, 32) int32 tensor
    holding the uint32 bit patterns [hash_hi x8 | hash_lo x8 | cid_strand
    x8 | pos x8]; cid_strand = (cid + 1) << 1 | strand, 0 = empty. A full
    bucket spills to the next one; `max_probes` is the longest chain.
    """

    def __init__(self, t_bkt: torch.Tensor, mask: int, max_probes: int):
        self.t_bkt = t_bkt
        self.mask = int(mask)
        self.max_probes = int(max_probes)

    @staticmethod
    def build_table(hashes: np.ndarray, contig_ids: np.ndarray,
                    positions: np.ndarray, strands: np.ndarray):
        """Host bucket build, bit-identical to mesh.DeviceIndex (:75-129).
        Returns (t_bkt (nb, 32) uint32 ndarray, mask, max_probes)."""
        n = int(hashes.shape[0])
        load = (
            BUCKET_LOAD_SMALL if n <= SMALL_TABLE_ENTRIES else BUCKET_LOAD
        )
        nb = 2
        while nb * load < n:
            nb <<= 1
        bmask = nb - 1
        hi = (hashes >> np.uint64(32)).astype(np.uint32)
        lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        cs = (
            ((contig_ids.astype(np.int64) + 1) << 1).astype(np.uint32)
            | strands.astype(np.uint32)
        )
        pos_u = positions.astype(np.uint32)

        ent = np.zeros((nb, 4, BUCKET), np.uint32)
        fill = np.zeros(nb, np.int32)
        cur = (
            ((lo ^ hi) * np.uint32(_FIB)).astype(np.uint32)
            & np.uint32(bmask)
        ).astype(np.int64)
        pending = np.arange(n)
        rounds = 0
        # insertion rounds: group pending entries by target bucket (stable
        # sort -> deterministic layout), rank within the group; ranks past
        # the bucket's free slots spill to the next bucket
        while pending.size:
            rounds += 1
            bs = cur[pending]
            so = np.argsort(bs, kind="stable")
            ps, bss = pending[so], bs[so]
            newgrp = np.empty(ps.size, bool)
            newgrp[0] = True
            newgrp[1:] = bss[1:] != bss[:-1]
            idx = np.arange(ps.size)
            start = np.maximum.accumulate(np.where(newgrp, idx, 0))
            rank = idx - start + fill[bss]
            place = rank < BUCKET
            pb, pr, pi = bss[place], rank[place], ps[place]
            ent[pb, 0, pr] = hi[pi]
            ent[pb, 1, pr] = lo[pi]
            ent[pb, 2, pr] = cs[pi]
            ent[pb, 3, pr] = pos_u[pi]
            np.add.at(fill, pb, 1)
            pending = ps[~place]
            cur[pending] = (cur[pending] + 1) & bmask
        return ent.reshape(nb, 4 * BUCKET), bmask, max(rounds, 1)

    @classmethod
    def from_numpy(cls, t_bkt: np.ndarray, mask: int, max_probes: int,
                   device="cpu") -> "DeviceIndex":
        """Carry a built table (e.g. ``np.asarray(jax_index.t_bkt)``) onto
        `device`."""
        t = np.array(t_bkt, dtype=np.uint32).view(np.int32)  # own copy
        return cls(torch.from_numpy(t).to(device), mask, max_probes)

    @classmethod
    def from_contig_index(cls, index, device="cpu") -> "DeviceIndex":
        """Build from a finalized ntlink_tpu.index.ContigIndex."""
        index.finalize()
        return cls.from_numpy(
            *cls.build_table(
                index.hashes, index.contig_ids, index.positions,
                index.strands,
            ),
            device=device,
        )


def _lo32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of int64 values, as the int32 with the same bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def hash_bucket_join(t_bkt: torch.Tensor, h: torch.Tensor, bmask: int,
                     max_probes: int):
    """Probe the bucket table for each int64 hash `h` (any shape): gather
    `max_probes` whole buckets per query and compare their 8 entries. Table
    keys are unique, so at most one entry matches. Returns (found, cid,
    cpos, cstrand) shaped like `h`; cid is -1 where not found."""
    q_hi = shr(h, 32)
    q_lo = h & 0xFFFFFFFF
    # uint32 (lo ^ hi) * FIB & bmask, computed in int64 (the low 32 bits of
    # a wrapped int64 product equal the uint32 product's)
    b0 = ((q_lo ^ q_hi) * _FIB) & bmask
    probes = torch.arange(max_probes, device=h.device)
    bs = (b0[..., None] + probes) & bmask
    rows = t_bkt[bs]                                  # (..., P, 32)
    eh = rows[..., 0:BUCKET]
    el = rows[..., BUCKET : 2 * BUCKET]
    ecs = rows[..., 2 * BUCKET : 3 * BUCKET]
    ep = rows[..., 3 * BUCKET : 4 * BUCKET]
    m = (
        (ecs != 0)
        & (eh == _lo32_as_i32(q_hi)[..., None, None])
        & (el == _lo32_as_i32(q_lo)[..., None, None])
    )
    flat = h.shape + (max_probes * BUCKET,)
    m2 = m.reshape(flat)
    found = m2.any(dim=-1)
    first = m2.to(torch.uint8).argmax(dim=-1, keepdim=True)
    cs = ecs.reshape(flat).gather(-1, first).squeeze(-1)
    pos = ep.reshape(flat).gather(-1, first).squeeze(-1)
    cid = torch.where(found, (cs >> 1) - 1, -1)
    return found, cid, pos, (cs & 1).to(torch.bool) & found


def select_minimizers(emit: torch.Tensor, slots: int):
    """Exact order-preserving compaction of emitted window indices to
    `slots` per row (cumsum + scatter). Returns (sel (B, S) int64 window
    indices, sel_ok (B, S) bool, n_minimizers (B,) int64). Rows with
    n_minimizers > slots keep only their first `slots` minimizers."""
    B, NW = emit.shape
    rank = emit.to(torch.int64).cumsum(dim=1) - 1
    keep = emit & (rank < slots)
    # dropped windows go to a dump column S, cut off below
    tgt = torch.where(keep, rank, slots)
    sel = torch.zeros((B, slots + 1), dtype=torch.int64, device=emit.device)
    win = torch.arange(NW, device=emit.device).expand(B, NW)
    sel.scatter_(1, tgt, win)
    n_min = emit.sum(dim=1)
    sel_ok = torch.arange(slots, device=emit.device)[None, :] < n_min[:, None]
    return sel[:, :slots], sel_ok, n_min


def compact_flat(mask: torch.Tensor, planes, width: int):
    """Pack plane[mask] (row-major order) to the front of `width` lanes,
    zeros after; one cumsum + scatter for all planes."""
    m = mask.reshape(-1)
    tgt = torch.where(m, m.to(torch.int64).cumsum(0) - 1, width)
    out = []
    for p in planes:
        o = torch.zeros(width + 1, dtype=p.dtype, device=p.device)
        o.scatter_(0, tgt, p.reshape(-1))
        out.append(o[:width])
    return out


def unpack_codes(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(B, L//4) 2-bit-packed uint8 (base i of a byte in bits 2i..2i+1)
    -> (B, L) uint8 codes 0..3."""
    shifts = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
    return ((packed[:, :, None] >> shifts) & 3).reshape(packed.shape[0], L)


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Host inverse of `unpack_codes` ((B, L) codes, L % 4 == 0)."""
    B, L = codes.shape
    c = codes.reshape(B, L // 4, 4).astype(np.uint8)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)


def unpack_bits(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(B, L//8) bit-packed uint8 (little bit order, as
    ``np.packbits(..., bitorder="little")``) -> (B, L) bool."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], L).to(torch.bool)


def sketch_batch(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                 w: int, L: int, nmask=None):
    """Unpack and sketch one batch: (can, fwd, winner, emit) as in
    `ops.sketch_torch.sketch_rows_ref`. `nmask` ((B, L//8) bit-packed
    uint8, ``stream_pipeline.split_n_rows``) marks the non-ACGT bases of a
    batch whose rows were cleaned to A for packing: the kernel's hash and
    strand planes are right on every k-mer that covers no such base, and
    the windows are taken again over the valid k-mers
    (`sketch_torch.compact_windows`)."""
    can, fwd, winner, emit = sketch_rows(unpack_codes(packed, L), lengths,
                                         k, w)
    if nmask is not None:
        winner, emit = compact_windows(can, unpack_bits(nmask, L), lengths,
                                       k, w)
    return can, fwd, winner, emit


def mapping_step(packed: torch.Tensor, lengths: torch.Tensor,
                 index: DeviceIndex, k: int, w: int, L: int, slots: int,
                 nmask=None, clen=None, z: int = 0,
                 runs: bool = False) -> torch.Tensor:
    """One batch: packed (B, L//4) uint8 and lengths (B,) int32 on the
    index's device -> the flat int32 payload described in the module
    docstring (2B + 3*B*slots lanes). `nmask`: see `sketch_batch`.

    With `clen` ((n_contigs,) int32 contig lengths on the device) and `z`,
    the chaining acceptance stages run here (`chain.chain_anchors_device`)
    and only the anchors of accepted runs ship; rows with more than
    RUN_LANES runs report n_minimizers > slots so that the host chains them
    exactly. With `runs` (which needs `clen`), the payload is O(runs):

        [n_runs (B) | overflow (B) | cid | count | f_cpos | l_cpos |
         f_rposw | l_rposw]   (each plane B*RUN_LANES lanes)

    where overflow is RUN_LANES + 1 for a row the host must map again
    (slot or run-lane overflow) and 0 otherwise, and the planes hold every
    row's merged runs packed to the front in read order."""
    B = packed.shape[0]
    can, fwd, winner, emit = sketch_batch(packed, lengths, k, w, L, nmask)
    sel, sel_ok, n_min = select_minimizers(emit, slots)
    m_pos = winner.to(torch.int64).gather(1, sel)
    h = finish_hash(can.gather(1, m_pos), k)
    m_fwd = fwd.gather(1, m_pos)
    found, cid, cpos, cstrand = hash_bucket_join(
        index.t_bkt, h, index.mask, index.max_probes
    )
    found &= sel_ok
    rposw = (
        m_pos.to(torch.int32)
        | (cstrand.to(torch.int32) << 29)
        | (m_fwd.to(torch.int32) << 30)
    )
    n_rep = n_min
    if clen is not None:
        found, chain_overflow = chain_anchors_device(
            found, cid, cpos, lengths, clen, z, k
        )
        if runs:
            valid, *fields = summarize_runs_device(found, cid, cpos, rposw)
            planes = compact_flat(valid, fields, B * RUN_LANES)
            over = (n_min > slots) | chain_overflow
            meta = torch.cat([
                valid.sum(dim=1), torch.where(over, RUN_LANES + 1, 0),
            ]).to(torch.int32)
            return torch.cat([meta] + planes)
        n_rep = torch.where(chain_overflow, n_min.clamp(min=slots + 1), n_min)
    planes = compact_flat(found, (rposw, cid, cpos), B * slots)
    meta = torch.cat([found.sum(dim=1), n_rep]).to(torch.int32)
    return torch.cat([meta] + planes)


def sketch_step(packed: torch.Tensor, lengths: torch.Tensor, k: int, w: int,
                L: int, max_mins: int, nmask=None) -> torch.Tensor:
    """Sketch-only step (``mesh.sketch_step_packed``): one batch ->

        [count (B) | n_minimizers (B) | pos_strand | hash_hi | hash_lo]

    in int32, each plane B*max_mins lanes holding every row's minimizers
    packed to the front in row order: pos_strand = position | fwd << 30,
    and the reported hash's uint32 halves. A row with n_minimizers >
    max_mins kept only its first max_mins and must be sketched again on
    the host; `count` is what it shipped."""
    B = packed.shape[0]
    can, fwd, winner, emit = sketch_batch(packed, lengths, k, w, L, nmask)
    sel, sel_ok, n_min = select_minimizers(emit, max_mins)
    m_pos = winner.to(torch.int64).gather(1, sel)
    h = finish_hash(can.gather(1, m_pos), k)
    pos_strand = m_pos.to(torch.int32) | (
        fwd.gather(1, m_pos).to(torch.int32) << 30
    )
    planes = compact_flat(
        sel_ok, (pos_strand, _lo32_as_i32(shr(h, 32)), _lo32_as_i32(h)),
        B * max_mins,
    )
    meta = torch.cat([sel_ok.sum(dim=1), n_min]).to(torch.int32)
    return torch.cat([meta] + planes)
