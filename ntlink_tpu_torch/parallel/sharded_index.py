"""Hash-sharded contig index across a 2-D (data, idx) grid of devices.

Counterpart of ``ntlink_tpu/parallel/sharded_index.py``. The default
engine replicates the contig hash table on every device; for an index that
outgrows one device's memory this variant shards the table by a hash
bucket over the ``idx`` axis of the grid:

- the build (`ShardedDeviceIndex`, host code, bit-identical to the JAX
  package's) partitions the entries by the top bits of the Fibonacci slot
  hash into `n_shards` open-addressing sub-tables, filled with the same
  vectorised contended-claim rounds, all shards at once on one flat table;
- the join (`_sharded_join`) splits a batch's rows into contiguous blocks
  over the ``data`` axis; every ``idx`` rank of a data row sketches the
  row's block on its own device (`ops.sketch_cuda.sketch_rows`: the Hopper
  kernel on a CUDA device) and probes its own sub-table, and the ranks'
  masked results are summed on the data row's first device, the ``psum``
  over ``idx`` of the JAX package (each query lives in exactly one shard,
  so the sum is the unique answer);
- `make_sharded_index_mapping_step` gathers the data rows on the grid's
  first device and applies the ``{flat, n_anchors}`` output contract: meta
  (count, n_minimizers) in flat row 0, then the anchor planes compacted to
  the front in read order, `with_hashes` planes last.

A grid is a list of rows of ``torch.device``; a device may stand in
several cells (``["cpu"] * 8`` in the tests, one card twice on a one-card
machine), and then its cells share its memory. On CUDA every cell works on
a stream of its own, so cells of one card overlap like cells of several.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence

import numpy as np
import torch

from .. import device as device_mod
from ..mapping_step import (
    _FIB, _lo32_as_i32, compact_flat, pack_codes, select_minimizers,
    unpack_bits, unpack_codes,
)
from ..ops.sketch_cuda import sketch_rows
from ..ops.sketch_torch import compact_windows, finish_hash, shr


def pack_table_rows(t_hi, t_lo, t_cid, t_pos, t_strand) -> np.ndarray:
    """Stack the five build-time table planes into (size, 4) uint32 rows
    [hash_hi, hash_lo, (cid+1)<<1 | strand, pos]; empty slots get row[2]=0
    (``mesh.pack_table_rows``)."""
    cs = np.where(
        t_cid >= 0,
        ((t_cid.astype(np.int64) + 1) << 1).astype(np.uint32)
        | t_strand.astype(np.uint32),
        np.uint32(0),
    ).astype(np.uint32)
    return np.stack(
        [t_hi, t_lo, cs, t_pos.astype(np.uint32)], axis=1
    )


def build_gpos_offsets(contig_ids: np.ndarray, positions: np.ndarray, n: int):
    """Global-position packing (``mesh.build_gpos_offsets``): anchors ship
    as one uint32 plane `gpos = off[cid] + cpos` instead of the two planes
    (cid, cpos); `off` gives each contig a span over its indexed positions.
    Off (3-plane layout) when the total span passes uint32. Returns
    (host_offsets int64 (n_contigs + 1,), pack, t_off uint32 (n_contigs,)
    ndarray or None)."""
    n_ctg = int(contig_ids.max()) + 1 if n else 1
    spans = np.zeros(n_ctg, np.int64)
    if n:
        np.maximum.at(spans, contig_ids, positions.astype(np.int64) + 1)
    offsets = np.zeros(n_ctg + 1, np.int64)
    np.cumsum(spans, out=offsets[1:])
    pack = bool(offsets[-1] <= 0xFFFFFFFF)
    t_off = offsets[:-1].astype(np.uint32) if pack else None
    return offsets, pack, t_off


class ShardedDeviceIndex:
    """Per-shard open-addressing sub-tables, stacked (n_shards, size, 4)
    uint32 on the host (`t_rows`); `_sharded_join` places shard j on the
    idx-rank-j device of every data row."""

    def __init__(self, hashes: np.ndarray, contig_ids: np.ndarray,
                 positions: np.ndarray, strands: np.ndarray, n_shards: int):
        assert n_shards & (n_shards - 1) == 0, "n_shards must be a power of 2"
        self.n_shards = n_shards
        n = int(hashes.shape[0])
        self.host_offsets, self.pack_gpos, self.t_off = build_gpos_offsets(
            contig_ids, positions, n
        )
        hi = (hashes >> np.uint64(32)).astype(np.uint32)
        lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        slot_hash = ((lo ^ hi) * np.uint32(_FIB)).astype(np.uint32)
        shard = (
            (slot_hash >> np.uint32(32 - int(np.log2(n_shards)))).astype(np.int64)
            if n_shards > 1
            else np.zeros(n, np.int64)
        )

        counts = np.bincount(shard, minlength=n_shards)
        size = 1
        while size < max(2 * int(counts.max() if counts.size else 1), 16):
            size <<= 1
        self.size = size
        self.mask = size - 1

        flat = n_shards * size
        t_hi = np.zeros(flat, np.uint32)
        t_lo = np.zeros(flat, np.uint32)
        t_cid = np.full(flat, -1, np.int32)
        t_pos = np.zeros(flat, np.int32)
        t_strand = np.zeros(flat, bool)

        # vectorized insertion: every pending entry claims its slot, one
        # winner per slot per round, losers advance one local slot
        # (wrapping within their shard's span)
        local = (slot_hash & np.uint32(self.mask)).astype(np.int64)
        base = shard * size
        pending = np.arange(n)
        claim = np.full(flat, -1, np.int64)
        rounds = 0
        while pending.size:
            rounds += 1
            want = base[pending] + local[pending]
            free = t_cid[want] == -1
            claim[want[free]] = pending[free]  # last writer wins; rest retry
            won = claim[want] == pending
            winners = pending[won]
            w_slots = base[winners] + local[winners]
            t_hi[w_slots] = hi[winners]
            t_lo[w_slots] = lo[winners]
            t_cid[w_slots] = contig_ids[winners]
            t_pos[w_slots] = positions[winners]
            t_strand[w_slots] = strands[winners]
            pending = pending[~won]
            local[pending] = (local[pending] + 1) & self.mask
        self.max_probes = (max(rounds, 1) + 3) & ~3
        # one contiguous 16 B row per slot
        self.t_rows = pack_table_rows(
            t_hi, t_lo, t_cid, t_pos, t_strand
        ).reshape(n_shards, size, 4)

    def decode_gpos(self, gplane: np.ndarray):
        """Invert the on-device gpos packing: int32 plane -> (cid, cpos)."""
        gpos = gplane.view(np.uint32).astype(np.int64)
        idx = np.searchsorted(self.host_offsets, gpos, side="right") - 1
        return (
            idx.astype(np.int32),
            (gpos - self.host_offsets[idx]).astype(np.int32),
        )

    @classmethod
    def from_contig_index(cls, index, n_shards: int) -> "ShardedDeviceIndex":
        index.finalize()
        return cls(
            index.hashes, index.contig_ids, index.positions, index.strands,
            n_shards,
        )


def make_mesh_2d(idx_shards: int,
                 devices: Sequence = None) -> List[List[torch.device]]:
    """(data, idx) grid over `devices` (default: every visible CUDA
    device): rows of `idx_shards` consecutive devices."""
    devs = device_mod.resolve_all(devices=devices)
    n = len(devs)
    assert n % idx_shards == 0, (n, idx_shards)
    return [devs[d * idx_shards : (d + 1) * idx_shards]
            for d in range(n // idx_shards)]


class _Cell:
    """One cell of the grid: its device, its stream on a CUDA device, and
    the sub-table of its idx rank."""

    def __init__(self, device: torch.device, t_rows: torch.Tensor):
        self.device = device
        self.t_rows = t_rows
        self.stream = (
            torch.cuda.Stream(device) if device.type == "cuda" else None
        )

    def work(self):
        """Context in which this cell's device calls run."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


def _bring(t: torch.Tensor, src: _Cell, dst: _Cell) -> torch.Tensor:
    """`t`, made by `src`'s work, on `dst`'s device and ordered into its
    stream."""
    if src is dst:
        return t
    if src.stream is None or dst.stream is None:
        return t.to(dst.device)
    dst.stream.wait_event(src.stream.record_event())
    # a copy between two cards runs on the current streams of both
    with torch.cuda.stream(src.stream), torch.cuda.stream(dst.stream):
        out = t.to(dst.device, non_blocking=True)
    if out.data_ptr() == t.data_ptr():
        t.record_stream(dst.stream)
    return out


def _sharded_join(mesh, sidx: ShardedDeviceIndex, k: int, w: int, L: int,
                  max_anchors: int):
    """Sketch + local probe + sum over ``idx``, on the grid.

    Returns (cells, fn); fn(packed, lengths, nmask=None) takes one batch
    ((B, L//4) 2-bit packed uint8, (B,) int32, optional (B, L//8) non-ACGT
    bit mask; host tensors, or tensors on any device) and returns, on the
    grid's first device and in its stream, (count, n_minimizers,
    rpos_packed, cid, cpos, found, h): per-row counts, then (B, S) planes
    with the strand bits in bits 29/30 of rpos_packed (the engine's anchor
    word) and the reported hash `h` (int64) of each selected minimizer."""
    n_shards = sidx.n_shards
    mask = sidx.mask
    max_probes = sidx.max_probes
    shard_shift = 32 - int(np.log2(n_shards)) if n_shards > 1 else 32
    assert all(len(row) == n_shards for row in mesh), "grid != n_shards wide"
    tables = {}  # one copy of a shard per device, shared by its cells

    def table_on(dev: torch.device, j: int) -> torch.Tensor:
        if (dev, j) not in tables:
            t = np.ascontiguousarray(sidx.t_rows[j]).view(np.int32)
            tables[(dev, j)] = torch.from_numpy(t).to(dev)
        return tables[(dev, j)]

    cells = [[_Cell(dev, table_on(dev, j)) for j, dev in enumerate(row)]
             for row in mesh]
    for row in cells:
        for cell in row:
            if cell.stream is not None:
                torch.cuda.synchronize(cell.device)  # tables are in place

    def local_probe(t_rows, j: int, h):
        """Probe idx rank j's sub-table: one gather of all `max_probes`
        16 B rows per query, gated by shard ownership. Linear-probe
        semantics: a hit counts iff no slot before it is empty."""
        q_hi, q_lo = shr(h, 32), h & 0xFFFFFFFF
        slot_hash = ((q_lo ^ q_hi) * _FIB) & 0xFFFFFFFF
        mine = (slot_hash >> shard_shift) == j
        probes = torch.arange(max_probes, device=h.device)
        slots = ((slot_hash & mask)[..., None] + probes) & mask
        rows = t_rows[slots]                               # (..., P, 4)
        occupied = rows[..., 2] != 0
        match = (
            occupied
            & (rows[..., 0] == _lo32_as_i32(q_hi)[..., None])
            & (rows[..., 1] == _lo32_as_i32(q_lo)[..., None])
        )
        before_empty = (~occupied).to(torch.int32).cumsum(dim=-1) == 0
        hit = match & before_empty & mine[..., None]
        found = hit.any(dim=-1)
        first = hit.to(torch.uint8).argmax(dim=-1, keepdim=True)
        cs = rows[..., 2].gather(-1, first).squeeze(-1)
        pos = rows[..., 3].gather(-1, first).squeeze(-1)
        cid = ((cs >> 1) - 1).clamp(min=0)
        return found, cid, pos, cs & 1

    def rank_step(cell: _Cell, j: int, packed, lengths, nmask):
        """One idx rank on its block: (found-masked [found, cid, cpos,
        cstrand] stacked (4, B, S) int32, and the block's m_pos, m_fwd,
        n_minimizers, h, which are the same on every rank)."""
        with cell.work():
            put = lambda t: None if t is None else t.to(
                cell.device, non_blocking=True)
            packed, lengths, nmask = put(packed), put(lengths), put(nmask)
            with torch.profiler.record_function("sharded_join/sketch"):
                can, fwd, winner, emit = sketch_rows(
                    unpack_codes(packed, L), lengths, k, w)
                if nmask is not None:
                    winner, emit = compact_windows(
                        can, unpack_bits(nmask, L), lengths, k, w)
            with torch.profiler.record_function("sharded_join/select"):
                sel, sel_ok, n_min = select_minimizers(emit, max_anchors)
                m_pos = winner.to(torch.int64).gather(1, sel)
                h = finish_hash(can.gather(1, m_pos), k)
                m_fwd = fwd.gather(1, m_pos)
            with torch.profiler.record_function("sharded_join/probe"):
                found, cid, cpos, cstrand = local_probe(cell.t_rows, j, h)
                found &= sel_ok
                part = torch.stack([found.to(torch.int32), cid, cpos,
                                    cstrand]) * found.to(torch.int32)
        return part, m_pos, m_fwd, n_min, h

    def data_row(row_cells, packed, lengths, nmask):
        first = row_cells[0]
        outs = [rank_step(cell, j, packed, lengths, nmask)
                for j, cell in enumerate(row_cells)]
        _, m_pos, m_fwd, n_min, h = outs[0]
        parts = [_bring(o[0], cell, first)
                 for o, cell in zip(outs, row_cells)]
        with first.work(), torch.profiler.record_function(
                "sharded_join/psum"):
            # each query lives in exactly one shard: the sum is its hit
            total = torch.stack(parts).sum(dim=0, dtype=torch.int32)
            found_any = total[0] > 0
            rpos_packed = (
                m_pos.to(torch.int32) | (total[3] << 29)
                | (m_fwd.to(torch.int32) << 30)
            )
            count = found_any.sum(dim=1).to(torch.int32)
            return (count, n_min.to(torch.int32), rpos_packed, total[1],
                    total[2], found_any, h)

    def join(packed, lengths, nmask=None):
        B = packed.shape[0]
        n_data = len(cells)
        bounds = [B * d // n_data for d in range(n_data + 1)]
        origin = cells[0][0]
        rows_out = []
        for d, row_cells in enumerate(cells):
            lo, hi = bounds[d], bounds[d + 1]
            if lo == hi:
                continue
            out = data_row(
                row_cells, packed[lo:hi], lengths[lo:hi],
                None if nmask is None else nmask[lo:hi],
            )
            rows_out.append([_bring(t, row_cells[0], origin) for t in out])
        with origin.work():
            return tuple(torch.cat(ts) for ts in zip(*rows_out))

    return cells, join


def make_sharded_index_mapping_step(mesh, sidx: ShardedDeviceIndex,
                                    k: int, w: int, L: int,
                                    max_anchors: int,
                                    with_hashes: bool = False):
    """Full mapping step over the hash-sharded index: packed input and the
    ``{flat, n_anchors}`` output contract, on the grid's first device.
    flat is (1 + planes, B * max_anchors) int32: row 0 holds [count (B) |
    n_minimizers (B)], the planes [rpos_packed, gpos] (or [rpos_packed,
    cid, cpos] when the index does not pack positions) hold the found
    anchors packed to the front in read order, and `with_hashes` adds the
    matched hashes' uint32 halves (the repeat filter's readback). `run`
    takes an optional `nmask` for N batches and carries `cells` (the
    grid's cells, `cells[0][0]` where the output lives)."""
    cells, join = _sharded_join(mesh, sidx, k, w, L, max_anchors)
    origin = cells[0][0]
    t_off = None
    if sidx.t_off is not None:
        t_off = torch.from_numpy(sidx.t_off.astype(np.int64)).to(
            origin.device)

    def run(packed, lengths, didx=None, nmask=None):
        count, n_mins, rpos_packed, cid, cpos, found, h = join(
            packed, lengths, nmask)
        with origin.work(), torch.profiler.record_function(
                "sharded_join/compact"):
            if t_off is not None:
                gpos = t_off[cid.to(torch.int64)] + cpos.to(torch.int64)
                fields = (rpos_packed, _lo32_as_i32(gpos))
            else:
                fields = (rpos_packed, cid, cpos)
            if with_hashes:
                fields += (_lo32_as_i32(shr(h, 32)), _lo32_as_i32(h))
            width = found.numel()
            planes = compact_flat(found, fields, width)
            meta_row = torch.zeros(width, dtype=torch.int32,
                                   device=origin.device)
            meta_row[: 2 * count.shape[0]] = torch.cat([count, n_mins])
            return {
                "flat": torch.stack([meta_row] + planes),
                "n_anchors": found.sum(),
            }

    run.cells = cells
    return run


def make_sharded_index_join(mesh, sidx: ShardedDeviceIndex,
                            k: int, w: int, max_anchors: int):
    """Compatibility wrapper over unpacked codes: fn(codes (B, L) uint8,
    lengths (B,) int32) -> per-read compacted rectangular anchors (count
    (B,), anchors (B, 4, S) = [pos, cid, cpos, strand_bits], -1 / 0 past a
    read's count)."""
    joins = {}

    def step(codes, lengths):
        codes = np.asarray(codes)
        L = codes.shape[1]
        if L not in joins:
            joins[L] = _sharded_join(mesh, sidx, k, w, L, max_anchors)
        origin = joins[L][0][0][0]
        count, _, rpos_packed, cid, cpos, found, _ = joins[L][1](
            torch.from_numpy(pack_codes(codes)),
            torch.from_numpy(np.asarray(lengths, dtype=np.int32)),
        )
        with origin.work():
            B, S = found.shape
            # per-row stable compaction of the found lanes to the front
            rank = found.to(torch.int64).cumsum(dim=1) - 1
            tgt = torch.where(found, rank, S)
            fields = (rpos_packed & 0x1FFFFFFF, cid, cpos,
                      (rpos_packed >> 29) & 3)
            fills = (-1, -1, -1, 0)
            out = []
            for f, fill in zip(fields, fills):
                o = torch.full((B, S + 1), fill, dtype=torch.int32,
                               device=found.device)
                o.scatter_(1, tgt, f.to(torch.int32))
                out.append(o[:, :S])
            return count, torch.stack(out, dim=1)

    return step

