"""Hash-sharded contig index across a 2-D (data, idx) grid of devices.

Counterpart of ``ntlink_tpu/parallel/sharded_index.py``. The default
engine replicates the contig hash table on every device; for an index that
outgrows one device's memory this variant shards the table by a hash
bucket over the ``idx`` axis of the grid:

- the build (`ShardedDeviceIndex`, host code, bit-identical to the JAX
  package's) partitions the entries by the top bits of the Fibonacci slot
  hash into `n_shards` open-addressing sub-tables, filled with the same
  vectorised contended-claim rounds, all shards at once on one flat table;
- the join (`_Grid`) splits a batch's rows into contiguous blocks over the
  ``data`` axis; every ``idx`` rank of a data row sketches the row's block
  on its own device (`ops.sketch_cuda.sketch_rows`: the Hopper kernel on a
  CUDA device) and probes its own sub-table, and the ranks' masked results
  are summed, the ``psum`` over ``idx`` of the JAX package (each query
  lives in exactly one shard, so the sum is the unique answer);
- `make_sharded_index_mapping_step` gathers the data rows on the grid's
  first device and applies the ``{flat, n_anchors}`` output contract: meta
  (count, n_minimizers) in flat row 0, then the anchor planes compacted to
  the front in read order, `with_hashes` planes last.

A grid is a list of rows of ``torch.device``; a device may stand in
several cells (``["cpu"] * 8`` in the tests, one card twice on a one-card
machine), and then its cells share its memory. The work of one batch is
split by device (`_Group`): each device runs one `group_step` for all of
its cells, each cell on a stream of its own (forked from the step's
stream and joined back, so cells of one card overlap like cells of
several), and sums its cells' results per data row. Every device but the
first sends its sums and its rank-0 minimizers to the first device, whose
step sums them into its own, gathers the rows and compacts the payload.

``jax.jit`` of the JAX package's step (`full_step`, `full_step_n` and the
join's `step`) is, here, a CUDA graph of each device's step per static
key (``step_graph.StepGraphs``, one set per device and grid): the key's
first batch runs eagerly, its second is captured, and every later batch
copies into the static inputs and replays. When every cell is on one
device, as on a card named twice, a batch is one graph launch; with
several devices the copies to the first device run between the replays,
ordered by the streams of both. The CPU and a device profile run the same
steps eagerly.
"""
from __future__ import annotations

import contextlib
from typing import List, Sequence

import numpy as np
import torch

from .. import device as device_mod
from .. import step_graph
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
    uint32 on the host (`t_rows`); `_Grid` places shard j on the
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
    """One cell of the grid: its device, its place (data row, idx rank),
    the sub-table of its idx rank, and its stream on a CUDA device."""

    def __init__(self, device: torch.device, t_rows: torch.Tensor, row: int,
                 rank: int):
        self.device = device
        self.t_rows = t_rows
        self.row, self.rank = row, rank
        self.stream = (
            torch.cuda.Stream(device) if device.type == "cuda" else None
        )

    def work(self):
        """Context in which this cell's device calls run."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def after(self, cur):
        """`work()`, its stream first made to wait for `cur` (the stream
        of the step that runs this cell; None on the CPU)."""
        if cur is not None and self.stream != cur:
            self.stream.wait_stream(cur)
        return self.work()


class _Group:
    """The cells of the grid on one device, in grid order; the group's
    stream is its first cell's."""

    def __init__(self, cells: List[_Cell]):
        self.cells = cells
        self.device = cells[0].device
        self.rows = sorted({c.row for c in cells})

    def work(self):
        return self.cells[0].work()


class _Grid:
    """The (data, idx) grid of one padded length L: the cells with their
    sub-tables (one copy of a shard per device, shared by its cells), and
    the cells grouped by device, the group of the grid's first device
    first (the origin, where the payload is made)."""

    def __init__(self, mesh, sidx: ShardedDeviceIndex, k: int, w: int,
                 L: int, max_anchors: int):
        n_shards = sidx.n_shards
        assert all(len(row) == n_shards for row in mesh), "grid != n_shards wide"
        self.k, self.w, self.L, self.slots = k, w, L, max_anchors
        self.mask = sidx.mask
        self.max_probes = sidx.max_probes
        self.shard_shift = (32 - int(np.log2(n_shards)) if n_shards > 1
                            else 32)
        tables = {}

        def table_on(dev: torch.device, j: int) -> torch.Tensor:
            if (dev, j) not in tables:
                t = np.ascontiguousarray(sidx.t_rows[j]).view(np.int32)
                tables[(dev, j)] = torch.from_numpy(t).to(dev)
            return tables[(dev, j)]

        self.cells = [[_Cell(dev, table_on(dev, j), d, j)
                       for j, dev in enumerate(row)]
                      for d, row in enumerate(mesh)]
        by_device: dict = {}
        for row in self.cells:
            for cell in row:
                by_device.setdefault(cell.device, []).append(cell)
        self.groups = [_Group(cells) for cells in by_device.values()]
        for g in self.groups:
            if g.device.type == "cuda":
                torch.cuda.synchronize(g.device)  # tables are in place

    def bounds(self, B: int) -> List[int]:
        """Row bounds of the data rows' blocks of a batch of B rows."""
        n = len(self.cells)
        return [B * d // n for d in range(n + 1)]

    def span(self, g: _Group, B: int):
        """(lo, hi): the batch rows that go to `g`'s device, from the first
        row of its first data row's block to the last of its last's."""
        b = self.bounds(B)
        return b[g.rows[0]], b[g.rows[-1] + 1]

    def upload_rows(self, B: int) -> int:
        """Batch rows uploaded for one batch: each device's span once."""
        return sum(hi - lo for lo, hi in (self.span(g, B)
                                          for g in self.groups))

    def layout(self, g: _Group, B: int, with_hashes: bool):
        """What a device other than the origin's sends there, in order, as
        (data row, field, shape) of one flat int32 tensor: each of its
        data rows' sum over its idx ranks, then, where it holds the row's
        rank 0, the row's minimizers (positions, strands, the hash halves
        with `with_hashes`, and n_minimizers)."""
        b = self.bounds(B)
        out = []
        for r in g.rows:
            n = b[r + 1] - b[r]
            if n == 0:
                continue
            out.append((r, "sum", (4, n, self.slots)))
            if self.cells[r][0] in g.cells:
                heads = ("m_pos", "m_fwd") + (("hi", "lo") if with_hashes
                                               else ())
                out += [(r, f, (n, self.slots)) for f in heads]
                out.append((r, "n_min", (n,)))
        return out

    def local_probe(self, t_rows, j: int, h):
        """Probe idx rank j's sub-table: one gather of all `max_probes`
        16 B rows per query, gated by shard ownership. Linear-probe
        semantics: a hit counts iff no slot before it is empty."""
        q_hi, q_lo = shr(h, 32), h & 0xFFFFFFFF
        slot_hash = ((q_lo ^ q_hi) * _FIB) & 0xFFFFFFFF
        mine = (slot_hash >> self.shard_shift) == j
        probes = torch.arange(self.max_probes, device=h.device)
        slots = ((slot_hash & self.mask)[..., None] + probes) & self.mask
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

    def rank_step(self, t_rows, j: int, packed, lengths, nmask,
                  with_hashes: bool):
        """One idx rank on its block: (found-masked [found, cid, cpos,
        cstrand] stacked (4, B, S) int32, and on rank 0 the block's
        minimizers, the same on every rank: (m_pos, m_fwd, n_minimizers,
        hash hi, hash lo), the halves None without `with_hashes`)."""
        k, w, L = self.k, self.w, self.L
        with torch.profiler.record_function("sharded_join/sketch"):
            can, fwd, winner, emit = sketch_rows(
                unpack_codes(packed, L), lengths, k, w)
            if nmask is not None:
                winner, emit = compact_windows(
                    can, unpack_bits(nmask, L), lengths, k, w)
        with torch.profiler.record_function("sharded_join/select"):
            sel, sel_ok, n_min = select_minimizers(emit, self.slots)
            m_pos = winner.to(torch.int64).gather(1, sel)
            h = finish_hash(can.gather(1, m_pos), k)
        with torch.profiler.record_function("sharded_join/probe"):
            found, cid, cpos, cstrand = self.local_probe(t_rows, j, h)
            found &= sel_ok
            part = torch.stack([found.to(torch.int32), cid, cpos,
                                cstrand]) * found.to(torch.int32)
        if j != 0:
            return part, None
        halves = ((_lo32_as_i32(shr(h, 32)), _lo32_as_i32(h)) if with_hashes
                  else (None, None))
        return part, (m_pos, fwd.gather(1, m_pos), n_min, *halves)

    def graph_sets(self) -> list:
        """A new graph set per group (None where its steps run eagerly).
        The grid's owner keeps them: a set's keys hold the grid, so the
        grid must not hold its sets."""
        return [step_graph.for_device(g.device) for g in self.groups]

    def run(self, packed, lengths, nmask, graphs, finish: str,
            with_hashes=False, t_off=None) -> torch.Tensor:
        """One batch through the grid ((B, L//4) packed uint8, (B,) int32
        lengths, optional (B, L//8) N mask; host tensors, pinned on a
        CUDA device, or tensors on any device): every device but the
        origin's runs its cells' step on its span of rows and sends the
        result to the origin, whose step runs its own cells and `finish`.
        Each device's step replays its graph in `graphs` (by group; None
        runs it eagerly) after its key's first batch (``step_graph``).
        Returns the origin step's output, on the origin's device and in its
        group's stream; a replay's is the graph's static output, which the
        next batch of its key overwrites."""
        B = packed.shape[0]
        origin = self.groups[0]
        remote = {}
        for gi, g in enumerate(self.groups[1:], 1):
            lo, hi = self.span(g, B)
            if lo == hi:
                continue  # padding rows alone
            with g.work():
                remote[f"from_{gi}"] = self._step(
                    g, gi, graphs[gi], B, packed[lo:hi], lengths[lo:hi],
                    None if nmask is None else nmask[lo:hi], None,
                    with_hashes, None, {})
        lo, hi = self.span(origin, B)
        with contextlib.ExitStack() as streams:
            # a copy from another card runs on the current streams of both
            for g in self.groups[1:]:
                streams.enter_context(g.work())
            streams.enter_context(origin.work())
            return self._step(
                origin, 0, graphs[0], B, packed[lo:hi], lengths[lo:hi],
                None if nmask is None else nmask[lo:hi], finish, with_hashes,
                t_off, remote)

    def static(self, gi: int, B: int, finish, with_hashes: bool, t_off
               ) -> dict:
        """The static arguments of group `gi`'s step on a batch of B rows
        (what its graph key holds besides the batch's shapes)."""
        return dict(grid=self, group=gi, B=B, k=self.k, w=self.w, L=self.L,
                    slots=self.slots,
                    tables=tuple(c.t_rows for c in self.groups[gi].cells),
                    t_off=t_off, finish=finish, with_hashes=with_hashes)

    def _step(self, g: _Group, gi: int, graphs, B: int, packed, lengths,
              nmask, finish, with_hashes, t_off, remote) -> torch.Tensor:
        """`group_step` of group `gi` for one batch: through its graph set
        `graphs`, or eagerly where there is none."""
        batch = dict(packed=packed, lengths=lengths, nmask=nmask, **remote)
        static = self.static(gi, B, finish, with_hashes, t_off)
        if graphs is not None:
            return graphs.run(group_step, batch, static)
        return group_step(**{n: None if t is None else t.to(g.device)
                             for n, t in batch.items()}, **static)


def group_step(packed, lengths, nmask=None, *, grid: _Grid, group: int,
               B: int, k: int, w: int, L: int, slots: int, tables: tuple,
               t_off, finish, with_hashes: bool, **remote) -> torch.Tensor:
    """The step of one device of the grid on its span of a batch of B rows
    (the function that its graphs capture; ``jax.jit`` of
    ``ntlink_tpu``'s `full_step`, `full_step_n` and the join's `step`,
    split by device): each of its cells, on its own stream forked from the
    caller's and joined back, sketches its data row's block and probes its
    sub-table (`tables`, in the order of the group's cells); the ranks'
    results are summed per data row (the ``psum`` over ``idx``).

    A device other than the origin's (`finish` None) returns its rows'
    sums and rank-0 minimizers as one flat int32 tensor
    (`_Grid.layout`). The origin's step takes those as `remote`
    (``from_<group>``), completes every data row, gathers the rows in
    order, and `finish`es: "flat", the ``{flat, n_anchors}`` contract's
    flat ((1 + planes, B * slots) int32, `t_off` packing (cid, cpos) into
    gpos when given, hash planes last with `with_hashes`), or "rows", the
    join's (B, 1 + 4 * slots) int32: count, then the [pos, cid, cpos,
    strand_bits] planes compacted per row (-1 / 0 past the count)."""
    assert (k, w, L, slots) == (grid.k, grid.w, grid.L, grid.slots)
    g = grid.groups[group]
    bounds = grid.bounds(B)
    lo0 = bounds[g.rows[0]]
    cur = (torch.cuda.current_stream(g.device)
           if g.device.type == "cuda" else None)
    outs = {}
    for cell, t_rows in zip(g.cells, tables):
        lo, hi = bounds[cell.row] - lo0, bounds[cell.row + 1] - lo0
        if lo == hi:
            continue
        with cell.after(cur):
            outs[cell] = grid.rank_step(
                t_rows, cell.rank, packed[lo:hi], lengths[lo:hi],
                None if nmask is None else nmask[lo:hi], with_hashes)
    if cur is not None:
        for cell in outs:
            if cell.stream != cur:
                cur.wait_stream(cell.stream)
    sums, heads = {}, {}
    for r in g.rows:
        parts = [outs[c][0] for c in g.cells if c.row == r and c in outs]
        if not parts:
            continue
        with torch.profiler.record_function("sharded_join/psum"):
            sums[r] = [parts[0] if len(parts) == 1
                       else torch.stack(parts).sum(dim=0, dtype=torch.int32)]
        head = outs.get(grid.cells[r][0])
        if head is not None:
            heads[r] = head[1]
    if finish is None:
        fields = {(r, "sum"): s[0] for r, s in sums.items()}
        for r, (m_pos, m_fwd, n_min, hi, lo) in heads.items():
            fields.update({(r, "m_pos"): m_pos, (r, "m_fwd"): m_fwd,
                           (r, "hi"): hi, (r, "lo"): lo, (r, "n_min"): n_min})
        return torch.cat([fields[(r, f)].reshape(-1).to(torch.int32)
                          for r, f, _ in grid.layout(g, B, with_hashes)])
    for name, flat in sorted(remote.items()):
        sent = grid.layout(grid.groups[int(name[len("from_"):])], B,
                           with_hashes)
        pieces = flat.split([int(np.prod(shape)) for _, _, shape in sent])
        got: dict = {}
        for (r, f, shape), t in zip(sent, pieces):
            got.setdefault(r, {})[f] = t.view(shape)
        for r, fields in got.items():
            sums.setdefault(r, []).append(fields["sum"])
            if "m_pos" in fields:
                heads[r] = (fields["m_pos"], fields["m_fwd"],
                            fields["n_min"], fields.get("hi"),
                            fields.get("lo"))
    rows_out = []
    for r in sorted(sums):
        parts = sums[r]
        m_pos, m_fwd, n_min, hi, lo = heads[r]
        with torch.profiler.record_function("sharded_join/psum"):
            # each query lives in exactly one shard: the sum is its hit
            total = (parts[0] if len(parts) == 1
                     else torch.stack(parts).sum(dim=0, dtype=torch.int32))
            found_any = total[0] > 0
            rpos_packed = (
                m_pos.to(torch.int32) | (total[3] << 29)
                | (m_fwd.to(torch.int32) << 30)
            )
            count = found_any.sum(dim=1).to(torch.int32)
        rows_out.append((count, n_min.to(torch.int32), rpos_packed, total[1],
                         total[2], found_any)
                        + ((hi, lo) if with_hashes else ()))
    count, n_mins, rpos_packed, cid, cpos, found, *halves = (
        torch.cat(ts) for ts in zip(*rows_out))
    if finish == "rows":
        return _rows_finish(count, rpos_packed, cid, cpos, found)
    with torch.profiler.record_function("sharded_join/compact"):
        if t_off is not None:
            gpos = t_off[cid.to(torch.int64)] + cpos.to(torch.int64)
            fields = (rpos_packed, _lo32_as_i32(gpos))
        else:
            fields = (rpos_packed, cid, cpos)
        width = found.numel()
        planes = compact_flat(found, fields + tuple(halves), width)
        meta_row = torch.zeros(width, dtype=torch.int32, device=found.device)
        meta_row[: 2 * count.shape[0]] = torch.cat([count, n_mins])
        return torch.stack([meta_row] + planes)


def _rows_finish(count, rpos_packed, cid, cpos, found) -> torch.Tensor:
    """The join's per-row stable compaction of the found lanes to the
    front: (B, 1 + 4 * S) int32, count then [pos, cid, cpos, strand_bits]
    (-1 / 0 past a read's count)."""
    B, S = found.shape
    rank = found.to(torch.int64).cumsum(dim=1) - 1
    tgt = torch.where(found, rank, S)
    fields = (rpos_packed & 0x1FFFFFFF, cid, cpos, (rpos_packed >> 29) & 3)
    fills = (-1, -1, -1, 0)
    out = []
    for f, fill in zip(fields, fills):
        o = torch.full((B, S + 1), fill, dtype=torch.int32,
                       device=found.device)
        o.scatter_(1, tgt, f.to(torch.int32))
        out.append(o[:, :S])
    return torch.cat([count[:, None], torch.stack(out, dim=1).reshape(B, -1)],
                     dim=1)


def _for_caller(grid: _Grid, out: torch.Tensor) -> torch.Tensor:
    """A copy of `out` (the origin step's output, in the origin group's
    stream) made in the caller's current stream, which the next batch's
    replay waits for."""
    origin = grid.groups[0]
    if origin.device.type != "cuda":
        return out.clone()
    cur = torch.cuda.current_stream(origin.device)
    stream = origin.cells[0].stream
    cur.wait_stream(stream)
    with torch.cuda.device(origin.device):
        copy = out.clone()
    stream.wait_stream(cur)
    return copy


class ShardedStep:
    """Full mapping step over the hash-sharded index for one padded length
    (`make_sharded_index_mapping_step`). `flat(packed, lengths, nmask)`
    is the read stream's call: the payload's flat, on the origin (the
    grid's first device, `cells[0][0]`) and in its stream; a call of the
    step itself gives the ``{flat, n_anchors}`` contract, copied into the
    caller's stream. `graphs` holds the graph set of each of the grid's
    devices (`groups`), None where the steps run eagerly; a test may put a
    stand-in there."""

    def __init__(self, grid: _Grid, t_off, with_hashes: bool):
        self.grid = grid
        self.cells = grid.cells
        self.groups = grid.groups
        self.graphs = grid.graph_sets()
        self.t_off = t_off
        self.with_hashes = with_hashes

    def flat(self, packed, lengths, nmask=None) -> torch.Tensor:
        return self.grid.run(packed, lengths, nmask, self.graphs, "flat",
                             self.with_hashes, self.t_off)

    def __call__(self, packed, lengths, didx=None, nmask=None) -> dict:
        flat = _for_caller(self.grid, self.flat(packed, lengths, nmask))
        return {"flat": flat, "n_anchors": flat[0, : packed.shape[0]].sum()}


def make_sharded_index_mapping_step(mesh, sidx: ShardedDeviceIndex,
                                    k: int, w: int, L: int,
                                    max_anchors: int,
                                    with_hashes: bool = False) -> ShardedStep:
    """Full mapping step over the hash-sharded index: packed input and the
    ``{flat, n_anchors}`` output contract, on the grid's first device.
    flat is (1 + planes, B * max_anchors) int32: row 0 holds [count (B) |
    n_minimizers (B)], the planes [rpos_packed, gpos] (or [rpos_packed,
    cid, cpos] when the index does not pack positions) hold the found
    anchors packed to the front in read order, and `with_hashes` adds the
    matched hashes' uint32 halves (the repeat filter's readback). The
    step takes an optional `nmask` for N batches."""
    grid = _Grid(mesh, sidx, k, w, L, max_anchors)
    t_off = None
    if sidx.t_off is not None:
        t_off = torch.from_numpy(sidx.t_off.astype(np.int64)).to(
            grid.groups[0].device)
    return ShardedStep(grid, t_off, with_hashes)


def make_sharded_index_join(mesh, sidx: ShardedDeviceIndex,
                            k: int, w: int, max_anchors: int):
    """Compatibility wrapper over unpacked codes: fn(codes (B, L) uint8,
    lengths (B,) int32) -> per-read compacted rectangular anchors (count
    (B,), anchors (B, 4, S) = [pos, cid, cpos, strand_bits], -1 / 0 past a
    read's count), in the caller's stream. One grid per L, whose graphs
    replay as the mapping step's do."""
    #: L -> (grid, its graph sets by group)
    grids = {}

    def step(codes, lengths):
        codes = np.asarray(codes)
        B, L = codes.shape
        if L not in grids:
            grid = _Grid(mesh, sidx, k, w, L, max_anchors)
            grids[L] = (grid, grid.graph_sets())
        grid, graphs = grids[L]
        out = _for_caller(grid, grid.run(
            torch.from_numpy(pack_codes(codes)),
            torch.from_numpy(np.asarray(lengths, dtype=np.int32)), None,
            graphs, "rows"))
        return out[:, 0], out[:, 1:].view(B, 4, max_anchors)

    step.grids = grids
    return step
