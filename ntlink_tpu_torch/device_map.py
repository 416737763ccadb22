"""Batched read mapping on torch devices: sketch + index join in PyTorch.

Counterpart of ``ntlink_tpu/device_map.py::DeviceMapper``. Reads stream
into (pad, has_n)-bucketed, 2-bit packed (B, pad/4) batches, N-containing
reads with a 1-bit mask of their non-ACGT bases
(``stream_pipeline.BatchStream``, which the contig sketcher's stream
shares; `_ReadBatches` is the reads' intake, step and decoding); one
`mapping_step.mapping_step`
per batch sketches them (the Hopper kernel on a CUDA device), joins the
minimizers against the contig table and compacts the matched anchors. On
a CUDA device each replica dispatches a batch as one CUDA graph replay of
that step, captured once per static key (``step_graph``, the counterpart
of ``DeviceMapper``'s jitted `_single_device_step`), and the hash-sharded
table's grid one replay per device (one in all when its cells share one
device); on the CPU and under a device profile the steps run eagerly.

Three payloads, with ``DeviceMapper``'s gates:

- per-anchor, host-chained (`prechain` None, or `with_hashes`): the host
  chains every read in C (`pipeline._map_reads_native` with
  prechained=0); `with_hashes` (repeats=True) ships each anchor's hash
  halves too, for the repeat filter that runs before chaining;
- per-anchor, prechained: the chaining acceptance stages run in the step
  (`chain.chain_anchors_device`) and only accepted anchors ship;
- O(runs) (`runs_only`, needs prechained): the step ships each read's
  merged runs, decoded here to chain.c's run rows [cid, count, f_cpos,
  f_rpos, f_sbits, l_cpos, l_rpos, l_sbits] for
  `pipeline._map_reads_runs`.

Reads the device does not take go to the exact host path
(`TorchMapper._host_map_raw`: native C sketch + sorted-index join, then
chain.c for the prechained and runs payloads) and are counted in
`host_fallbacks`: sub-k reads, reads over MAX_PAD, and reads whose
minimizers overflow the slot budget or whose runs overflow RUN_LANES.
Every path gives the same raw payload as ``DeviceMapper`` and
``HostMapper`` with the same arguments.

With several devices (`devices=`, default every visible CUDA device; one
device may be named several times) the index is replicated: each device
holds its own `DeviceIndex` and contig lengths, a batch's rows split into
contiguous blocks, each device runs `mapping_step` on its block on a
stream of its own (``mesh.make_sharded_mapping_step``'s data axis), and the
blocks' payloads are read back in row order, so every read's payload is
the one-device payload. Each replica has its own graphs. Hash sharding
shards the table instead over a (data, idx) grid
(`parallel.sharded_index`); it chains on the host, and with one device it
runs replicated, as ``DeviceMapper`` does. `TorchMapper.__init__` chooses
the layout's steps once (`_ReplicaSet` or `_HashGrid`): their uploads and
step calls, launches, join counting, text and payload layout.

The stream accounts for itself as ``DeviceMapper``'s does. `wire_stats`
counts, over every stream of the mapper, the bytes handed to the devices
(`h2d`: each batch's packed codes, lengths and N mask, the rows each
device gets, once per device) and brought back (`d2h`), and the seconds
the feeder spent in the uploads' host side (`h2d_s`: the copy into pinned
memory and the enqueue; the upload itself is asynchronous) and the drainer
blocked on the payloads (`d2h_s`: that wait covers the batch's step on the
device as well as the copy, since the copy is queued behind it). ``DeviceMapper``'s
`d2h` counts its capped-transfer protocol; this mapper copies each batch's
whole payload, so its `d2h` is that payload's size. ``NTLINK_TIMING=1``
adds the per-phase split of the hot loop (`last_timing`, and a
``# ntlink timing:`` line on stderr when the stream closes), and
``NTLINK_PIPE_DEPTH`` sets the batches in flight (default `DEPTH`).
With graphs, `h2d_s` is the copy into pinned memory alone: the upload's
enqueue is in `dispatch`, with the replay.

`join_stats` counts what the replicated table's bucket join
(`mapping_step.hash_bucket_join`) does, over every stream: its `slots`
(each device call's rows times the batch's slot budget S, padding rows
and empty slots included: the join probes every slot), its `queries` (the
valid minimizers among them, min(n_minimizers, S) a row from the
payload's header, which reads S for a row whose runs overflow the run
lanes; not counted from runs-only payloads, whose header holds no
n_minimizers) and its `bucket_bytes` (slots x `max_probes` x 128 B of
bucket rows gathered). They are counted only while the Tracer is on,
once a device call, never once a read: each such stream's summary line
gives its own, and they go to ``tracing.GLOBAL`` as a ``map/join`` count,
as the table's `TableLayout` goes at ``table/build``. A held stream's
line also gives its consumer's ``render/verbose`` count (the anchors and
bytes of its verbose lines), again only while the Tracer is on. So does
`decode_stats`, what the drainer's decoding of each device block
(`_ReadBatches.decode`) does, in either layout: the `blocks` decoded, the
`rows` delivered with anchors from a block's arrays, the `remaps` (rows
over their slot or run-lane budget, for the host path) and the `empty`
rows (no anchor), counted once a block and taken as a ``map/decode``
count.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import device as device_mod
from . import step_graph, tracing
from .chain import CHAIN_MAX_CONTIGS, RUN_LANES
from .index import ContigIndex
from .mapping import AnchorHit
from .mapping_step import BUCKET_BYTES, DeviceIndex, mapping_step
from .native import chain_module, sketch_module
from .ops import nthash_np, sketch_cuda
from .ops.nthash_np import Minimizers
from .parallel.sharded_index import (
    ShardedDeviceIndex, make_mesh_2d, make_sharded_index_mapping_step,
)
from .seqio.fastx import CodeBlock, code_blocks
from .stream_pipeline import BatchStream, PhaseTimer, next_pow2


#: the producer thread's keys that `_ReadBatches.run` times inside itself,
#: which `read_prep` leaves out
_STREAM_KEYS = ("reader_pull", "host_remap", "pack", "feed_enqueue_wait",
                "flush_join")

#: reads of a block that `map_stream_raw` groups a per-record caller's
#: reads into: enough to spread the intake's per-block NumPy calls thin,
#: few enough that a caller handing reads over one at a time, with pauses
#: between them, gets results back before it ends its input
PAIR_BLOCK_READS = 32


def as_blocks(items: Iterable, block_bases: int) -> Iterator[CodeBlock]:
    """`items` as `CodeBlock`s: blocks pass as they are; (name, codes or
    sequence) pairs are grouped into blocks of up to `PAIR_BLOCK_READS`
    reads or `block_bases` bases (``seqio.fastx.code_blocks``). The first
    item decides which."""
    items = iter(items)
    first = next(items, None)
    if first is None:
        return
    rest = itertools.chain([first], items)
    if isinstance(first, CodeBlock):
        yield from rest
        return
    codes = ((name, payload if isinstance(payload, np.ndarray)
              else nthash_np.encode(payload)) for name, payload in rest)
    yield from code_blocks(codes, block_bases, PAIR_BLOCK_READS)


class _Remap:
    """A read for the exact host path (one the device does not take, or a
    device row that overflowed its slot budget): the consumer thread maps
    its codes there when the read's turn comes."""

    __slots__ = ("codes",)

    def __init__(self, codes: np.ndarray):
        self.codes = codes


def default_idx_shards(n_devices: int) -> int:
    """Largest power-of-two divisor of the device count (capped at 4):
    make_mesh_2d needs idx_shards | n_devices and the sharded table needs a
    pow2 shard count (e.g. 6 devices -> 2, not 4; 3 devices -> 1)."""
    s = 1
    while s < 4 and n_devices % (s * 2) == 0:
        s *= 2
    return s


class Replica:
    """One device's share of the replicated layout: its index and contig
    lengths, on a CUDA device that is one of several the stream its
    batches run on, and the graphs of its steps (`graphs`: a
    ``step_graph.StepGraphs``, None where the step runs eagerly; a test may
    put a stand-in there)."""

    def __init__(self, device: torch.device, didx: DeviceIndex, clen,
                 own_stream: bool):
        self.device = device
        self.didx = didx
        self.clen = clen
        self.stream = (
            torch.cuda.Stream(device)
            if own_stream and device.type == "cuda" else None
        )
        #: sketch kernel launches on this replica
        self.launches = 0
        self.graphs = step_graph.for_device(device)

    def work(self):
        """Context in which this replica's device calls run."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


def _render_since(counts0: Optional[int]) -> str:
    """The ``render/verbose`` counts taken since the Tracer held `counts0`
    counts (None: the Tracer off), as a clause of the summary line. A
    consumer that holds the stream (`pipeline._map_reads_native`) takes
    its count before the line is printed."""
    if counts0 is None:
        return ""
    got = [c.values for c in tracing.GLOBAL.counts[counts0:]
           if c.name == "render/verbose"]
    if not got:
        return ""
    anchors = sum(v["anchors"] for v in got)
    nbytes = sum(v["bytes"] for v in got)
    return f"verbose rendering: {anchors} anchors, {nbytes} bytes; "


class TorchMapper:
    """Raw-payload read mapper on torch devices (``DeviceMapper``'s
    contract: `contig_names`, `_contig_order`, `prechained`, `runs_only`,
    `host_fallbacks`, `map_stream_raw`, `map_stream`)."""

    MIN_PAD = 1 << 10
    MAX_PAD = 1 << 21
    #: bases of one block of reads that the reader hands to the stream
    #: (`map_stream_raw`; ~150 ONT reads of 10-15 kb), a quarter of the
    #: default `batch_bases`
    BLOCK_BASES = 1 << 21
    #: in-flight batches between the producer, feeder and drainer threads
    #: (NTLINK_PIPE_DEPTH overrides it)
    DEPTH = 4

    def __init__(self, index: ContigIndex, k: int, w: int,
                 batch_bases: int = 8_000_000, device=None, prechain=None,
                 runs_only: bool = False, with_hashes: bool = False,
                 devices=None, index_sharding: str = "replicated",
                 idx_shards: int = 0, table=None):
        """`table`: a `DeviceIndex.build_table` result of this index to
        upload, in place of building one (replicated layout)."""
        self.devices = device_mod.resolve_all(device, devices)
        self.device = self.devices[0]
        self.n_devices = len(self.devices)
        if index_sharding == "hash" and self.n_devices == 1:
            index_sharding = "replicated"  # nothing to shard over
        self.index_sharding = index_sharding
        index.finalize()
        self.index = index
        self.k, self.w = k, w
        self.batch_bases = batch_bases
        self.contig_names: List[str] = index.contig_names
        self._contig_order = {n: i for i, n in enumerate(index.contig_names)}
        self.with_hashes = bool(with_hashes)
        # on-device chaining when `prechain` = (contig lengths in contig-id
        # order, z) and DeviceMapper's gates hold (a replicated index: the
        # hash-sharded step keeps host chaining; no hash planes: the
        # repeat filter must run before chaining);
        # `_host_map_raw` reads `prechained`, `runs_only`, `_chain_sel` and
        # `_chain_z`, so fallback rows ship the same payload kind
        self.prechained = False
        clen_np = None
        self._chain_z = 0
        self._chain_sel = None
        if (
            prechain is not None
            and index_sharding != "hash"
            and not self.with_hashes
            and len(index.contig_names) <= CHAIN_MAX_CONTIGS
        ):
            cm = chain_module()
            if cm is not None:  # exact host chaining for fallback rows
                clen_arr, z = prechain
                clen_np = np.ascontiguousarray(clen_arr, dtype=np.int32)
                self._chain_z = int(z)
                self._chain_sel = cm.Chainer(clen_np, index.contig_names)
                self.prechained = True
        self.runs_only = bool(runs_only) and self.prechained
        self._replicas: List[Replica] = []
        if index_sharding == "hash":
            self.idx_shards = idx_shards or default_idx_shards(self.n_devices)
            #: the layout's steps, chosen once (`_HashGrid`, `_ReplicaSet`)
            self._steps = _HashGrid(self)
            self.didx = self._steps.didx
            self._mesh2d = self._steps.mesh
            self._hash_steps = self._steps.steps
        else:
            self.idx_shards = 1
            with tracing.GLOBAL.stage("table/build"):
                t0 = time.perf_counter()
                if table is None:
                    table = DeviceIndex.build_table(
                        index.hashes, index.contig_ids, index.positions,
                        index.strands)
                t1 = time.perf_counter()
            with tracing.GLOBAL.stage("table/upload"):
                t2 = time.perf_counter()
                on_device: Dict[torch.device, tuple] = {}
                for dev in self.devices:
                    if dev not in on_device:  # one copy per device
                        on_device[dev] = (
                            DeviceIndex.from_numpy(*table, device=dev,
                                                   layout=table.layout),
                            None if clen_np is None
                            else torch.from_numpy(clen_np).to(dev),
                        )
                    self._replicas.append(
                        Replica(dev, *on_device[dev],
                                 own_stream=self.n_devices > 1))
                self.didx = self._replicas[0].didx
                for dev in on_device:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)  # tables are in place
                t3 = time.perf_counter()
            #: host seconds of the table's build (0 for a given `table`)
            #: and of its upload to every device: the spans table/build
            #: and table/upload (v=1)
            self.build_seconds = t1 - t0
            self.upload_seconds = t3 - t2
            tracing.GLOBAL.count("table/build", **vars(self.didx.layout))
            self._steps = _ReplicaSet(self)
        self.host_fallbacks = 0
        #: reads whose anchors came from a device batch
        self.device_reads = 0
        #: blocks of reads taken in, over every stream
        self.read_blocks = 0
        #: device batches dispatched, by (padded row length, has N)
        self.batches_by_pad: Dict[Tuple[int, bool], int] = {}
        #: sketch kernel launches of every stream so far
        self.kernel_launches = 0
        #: wall seconds of every read stream so far (the summary line's)
        self.stream_seconds = 0.0
        #: bytes to and from the devices and the seconds the feeder and the
        #: drainer spent on them, over every stream (see the module's text);
        #: the feeder writes h2d and h2d_s, the drainer d2h and d2h_s
        self.wire_stats = {"h2d": 0, "d2h": 0, "h2d_s": 0.0, "d2h_s": 0.0}
        #: the bucket join's slots, valid queries and bytes of bucket rows
        #: gathered, over every stream the Tracer was on for (see the
        #: module's text; replicated layout only); the feeder writes slots
        #: and bucket_bytes, the drainer queries
        self.join_stats = {"slots": 0, "queries": 0, "bucket_bytes": 0}
        #: the drainer's decoded blocks, and their rows with anchors,
        #: remapped and empty, over every stream the Tracer was on for
        self.decode_stats = {"blocks": 0, "rows": 0, "remaps": 0, "empty": 0}
        #: NTLINK_TIMING=1: the last stream's {phase: (seconds, spans)};
        #: empty when the variable is unset
        self.last_timing: Dict[str, Tuple[float, int]] = {}
        #: NTLINK_TIMING=1: the last stream's {phase: CPU seconds of its
        #: thread in it}, for the phases that carry them, and {thread:
        #: its whole CPU seconds in the stream} (the producer's, and the
        #: reader's where `pipeline.map_reads` parsed the file)
        self.last_cpu: Dict[str, float] = {}
        self.last_thread_cpu: Dict[str, float] = {}
        #: (thread id, timer) of a `hold_stream` block that is open
        self._held = None

    @property
    def blocks_ahead(self) -> int:
        """Blocks of `BLOCK_BASES` that a reader thread may parse ahead of
        the stream: one `flush_all`'s worth of reads. The stream takes no
        block while a flush joins and delivers, then the next flush's
        blocks in a burst, so a shallower queue stalls the reader in the
        one and the stream in the other."""
        return -(-BatchStream.FLUSH_BATCHES * self.batch_bases
                 // self.BLOCK_BASES)

    def _slots_for(self, L: int) -> int:
        """Minimizer slot budget for padded length L (density ~2/(w+1))."""
        return next_pow2(max(128, int(2.5 * L / (self.w + 1)) + 64))

    def layout(self) -> str:
        """The index layout that runs, for the summary line."""
        return self._steps.text

    def graph_counts(self):
        """(captures, replays, capture seconds, first batches run
        eagerly) of every replica's step graphs, or of every device's of
        the hash-sharded grids, so far; None where every step runs
        eagerly."""
        return step_graph.counts(self._steps.graph_sets())

    def launches_by_device(self) -> List[int]:
        """Sketch kernel launches of each replica (replicated layout), or
        of the whole grid in one entry (hash-sharded: every cell launches
        once per batch)."""
        return self._steps.launches()

    def _host_map_raw(self, codes: np.ndarray):
        """Host fallback producing the raw array payload (exact path):
        native C rolling sketcher when built, NumPy otherwise.

        Counted per-mapper (`host_fallbacks`); a summary line is printed at
        stream end so a fallback-heavy run (e.g. many ultra-long reads over
        MAX_PAD) is visible instead of just mysteriously slow."""
        self.host_fallbacks += 1
        sm = sketch_module()
        if sm is not None:
            _, hb, pb, fb = sm.sketch(
                np.ascontiguousarray(codes), self.k, self.w
            )
            mins = Minimizers(
                np.frombuffer(hb, np.uint64),
                np.frombuffer(pb, np.int64),
                np.frombuffer(fb, np.uint8).astype(bool),
            )
        else:
            mins = nthash_np.sketch_codes(codes, self.k, self.w)
        found, cid, cpos, cstrand = self.index.lookup_many(mins.hashes)
        if not found.any():
            return None
        hashes = mins.hashes[found]
        n = int(hashes.shape[0])
        rpos = mins.positions[found].astype(np.int32)
        sbits = (
            cstrand[found].astype(np.int32)
            | (mins.forward[found].astype(np.int32) << 1)
        )
        hi = (hashes >> np.uint64(32)).astype(np.uint32).view(np.int32)
        lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        rpos = np.ascontiguousarray(rpos)
        cid = np.ascontiguousarray(cid[found].astype(np.int32))
        cpos = np.ascontiguousarray(cpos[found].astype(np.int32))
        sbits = np.ascontiguousarray(sbits)
        if self.runs_only:
            # payload contract is per-RUN summaries: run the full exact C
            # chain and keep only the run rows (chain.c row layout [cid,
            # count, f_cpos, f_rpos, f_sbits, l_cpos, l_rpos, l_sbits])
            runs_b, _, _, _ = self._chain_sel.chain_batch(
                cid, cpos, rpos, sbits,
                np.array([0, n], np.int64),
                np.array([len(codes)], np.int32),
                None, self.k, self._chain_z, 0, 0.0, 0, 0,
            )
            rr = np.frombuffer(runs_b, np.int32).reshape(-1, 8)
            if rr.shape[0] == 0:
                return None
            return (rr.shape[0], rr)
        if self.prechained:
            # the payload contract for this mapper is PRE-CHAINED anchors
            # (on-device chaining) — apply the identical acceptance stages
            # exactly in C for fallback rows
            sel = np.frombuffer(
                self._chain_sel.chain_select(
                    cid, cpos, rpos, sbits,
                    len(codes), self.k, self._chain_z, 0, 0.0,
                ),
                np.int32,
            )
            n = len(sel)
            if n == 0:
                return None
            rpos, cid, cpos, sbits = (
                np.ascontiguousarray(rpos[sel]),
                np.ascontiguousarray(cid[sel]),
                np.ascontiguousarray(cpos[sel]),
                np.ascontiguousarray(sbits[sel]),
            )
            hi = np.ascontiguousarray(hi[sel])
            lo = np.ascontiguousarray(lo[sel])
        return (n, rpos, cid, cpos, sbits, hi, lo)

    def map_stream(
        self, named_seqs: Iterable[Tuple[str, str]]
    ) -> Iterator[Tuple[str, int, List[Tuple[str, AnchorHit]]]]:
        """Yield (read_name, read_len, [(contig, AnchorHit)...]) in order."""
        assert not self.runs_only, "runs-only payloads have no per-hit view"
        names = self.contig_names
        for name, length, raw in self.map_stream_raw(named_seqs):
            if raw is None:
                yield name, length, []
                continue
            n, rpos, cid, cpos, sbits, hi, lo = raw
            hits = [
                (
                    names[c],
                    AnchorHit(
                        h,
                        p,
                        "+" if b & 1 else "-",
                        r,
                        "+" if b & 2 else "-",
                    ),
                )
                for r, c, p, b, h in zip(
                    rpos[:n].tolist(),
                    cid[:n].tolist(),
                    cpos[:n].tolist(),
                    sbits[:n].tolist(),
                    (
                        (hi[:n].view(np.uint32).astype(np.uint64) << np.uint64(32))
                        | lo[:n].view(np.uint32).astype(np.uint64)
                    ).tolist(),
                )
            ]
            yield name, length, hits

    @contextlib.contextmanager
    def _accounted(self, timer: PhaseTimer):
        """The accounting of one read stream around a `with` block: its
        wall (`stream_seconds`), its NTLINK_TIMING split (`last_timing`,
        `last_cpu`, `last_thread_cpu`, the ``# ntlink timing:`` and
        ``# ntlink cpu:`` lines) and its summary line."""
        launches0 = sketch_cuda.launches
        graphs0 = self.graph_counts()
        reads0 = self.device_reads + self.host_fallbacks
        blocks0 = self.read_blocks
        join0 = dict(self.join_stats) if tracing.GLOBAL.enabled else None
        decode0 = dict(self.decode_stats) if tracing.GLOBAL.enabled else None
        counts0 = len(tracing.GLOBAL.counts) if tracing.GLOBAL.enabled else None
        t0 = time.perf_counter()
        c0 = timer.cpu_now()
        try:
            yield timer
        finally:
            secs = time.perf_counter() - t0
            timer.thread_cpu_since("producer", c0)
            self.stream_seconds += secs
            self.last_timing = dict(timer.acc)
            self.last_cpu = dict(timer.cpu)
            self.last_thread_cpu = dict(timer.thread_cpu)
            if timer.acc:
                print(timer.line(), file=sys.stderr)
                print(timer.cpu_line(), file=sys.stderr)
            self.kernel_launches += sketch_cuda.launches - launches0
            n = self.device_reads + self.host_fallbacks - reads0
            blocks = self.read_blocks - blocks0
            mode = (
                "runs-only" if self.runs_only
                else "prechained" if self.prechained else "host-chained"
            )
            join = self._join_since(join0)
            decode = self._decode_since(decode0)
            render = _render_since(counts0)
            print(
                f"# ntlink_tpu_torch device-map ({self.layout()}, {mode}): {n} "
                f"read(s) in {secs:.3f} s ({n / max(secs, 1e-9):.1f} "
                f"reads/s) in {blocks} block(s) of "
                f"{n / max(blocks, 1):.1f} reads; "
                f"{sketch_cuda.launches - launches0} sketch "
                f"kernel launch(es); so far {self.device_reads} read(s) "
                f"on the device, batches by (pad, has N) "
                f"{self.batches_by_pad}, and {self.host_fallbacks} on the "
                f"exact host path (sub-k, > {self.MAX_PAD} bases, slot or "
                f"run-lane overflow); {join}{decode}{render}"
                f"{step_graph.summary(self.graph_counts(), graphs0)}",
                file=sys.stderr,
            )

    def _join_since(self, join0: Optional[Dict[str, int]]) -> str:
        """The bucket join's counts of the stream that began at `join0`
        (None: not counted, the Tracer off), as a clause of the summary
        line, and to ``tracing.GLOBAL``."""
        if join0 is None or not self._steps.counts_join:
            return ""
        layout = self.didx.layout
        d = {key: self.join_stats[key] - join0[key] for key in join0}
        if self.runs_only:
            del d["queries"]
        tracing.GLOBAL.count("map/join", **d, max_probes=layout.max_probes)
        queries = ("queries not counted (runs-only payloads)"
                   if self.runs_only else f"{d['queries']} valid queries")
        return (f"bucket join ({layout.entries} entries in {layout.buckets} "
                f"buckets, {layout.regime}, max_probes {layout.max_probes}): "
                f"{d['slots']} slots, {queries}, {d['bucket_bytes']} bytes "
                f"of buckets gathered; ")

    def _decode_since(self, decode0: Optional[Dict[str, int]]) -> str:
        """The drainer's decode counts of the stream that began at `decode0`
        (None: not counted, the Tracer off), as a clause of the summary
        line, and to ``tracing.GLOBAL``."""
        if decode0 is None:
            return ""
        d = {key: self.decode_stats[key] - decode0[key] for key in decode0}
        tracing.GLOBAL.count("map/decode", **d)
        return (f"decoded {d['blocks']} device block(s): {d['rows']} rows "
                f"with anchors, {d['remaps']} remapped, {d['empty']} empty; ")

    @contextlib.contextmanager
    def hold_stream(self, timer: PhaseTimer):
        """Hold the accounting of the read stream that `map_stream_raw`
        starts on this thread inside the `with` block open until the block
        ends: the stream takes `timer`, and its wall, `last_timing` and
        summary line end with the block, not at its last read. A consumer
        that iterates the stream on this thread keys its own work in
        `timer` (``PhaseTimer.THREADS["producer"]``), and so brings its
        work on the stream's last reads inside the stream's wall. The
        stream's signature stays ``map_stream_raw(named_seqs)``, which
        wrappers of it rely on."""
        with self._accounted(timer):
            self._held = (threading.get_ident(), timer)
            try:
                yield timer
            finally:
                self._held = None

    def map_stream_raw(self, named_seqs: Iterable):
        """Yield (read_name, read_len, raw) in input order. raw is None, or
        (n, rpos, cid, cpos, sbits, hi, lo) int32 arrays (hi = lo = 0 on
        device rows unless `with_hashes`), or with
        `runs_only` (n, runs) where runs is chain.c's (n, 8) int32 run
        rows. The reads come in `CodeBlock`s
        (``seqio.fastx.stream_code_blocks``), or as (name, codes or
        sequence) pairs, which are grouped into blocks of up to
        `PAIR_BLOCK_READS` (`as_blocks`). Inside `hold_stream` on this
        thread the stream takes the holder's timer; otherwise it accounts
        for itself, from NTLINK_TIMING as its first read is asked for."""
        blocks = as_blocks(named_seqs, self.BLOCK_BASES)
        held = self._held
        if held is not None and held[0] == threading.get_ident():
            return self._timed_stream(blocks, held[1])
        return self._accounted_stream(blocks)

    def _accounted_stream(self, blocks):
        with self._accounted(PhaseTimer.from_env()) as timer:
            yield from self._timed_stream(blocks, timer)

    def _timed_stream(self, blocks, timer: PhaseTimer):
        stream = _ReadBatches(self, timer).run(blocks)
        if timer.on:
            # read_prep: this generator's own time on this thread
            stream = timer.self_timed(stream, "read_prep", _STREAM_KEYS)
        return stream


class _ReplicaSet:
    """The replicated layout's steps: every device holds the whole table
    (`TorchMapper._replicas`); a batch's rows split into contiguous
    blocks, one a device, each device's step on its own stream, and the
    blocks' payloads come back in row order. The bucket join is counted
    here (`TorchMapper.join_stats`)."""

    counts_join = True

    def __init__(self, m: TorchMapper):
        self.mapper, self.replicas = m, m._replicas
        self.text = (f"{m.device}, index replicated" if m.n_devices == 1
                     else f"index replicated on {m.n_devices} devices "
                     f"{[str(d) for d in m.devices]}")

    def graph_sets(self) -> list:
        return [rep.graphs for rep in self.replicas]

    def launches(self) -> List[int]:
        return [rep.launches for rep in self.replicas]

    def run(self, stream: "_ReadBatches", pad: int, slots: int, packed,
            nmask, lengths, n_rows: int) -> list:
        # each block of rows goes to its device in turn; the calls return
        # before the device is done, so the devices work at once
        m, timer, join = self.mapper, stream.timer, self.mapper.join_stats
        B = len(lengths)
        n = len(self.replicas)
        bounds = [B * d // n for d in range(n + 1)]
        blocks = []
        for rep, lo, hi in zip(self.replicas, bounds, bounds[1:]):
            if lo >= min(hi, n_rows):
                continue  # no row, or padding rows alone
            with rep.work():
                launches = sketch_cuda.launches
                # a graph set takes the host tensors and copies them into
                # its static inputs itself
                p, ln, nm = stream.upload(
                    rep.device, packed[lo:hi], lengths[lo:hi],
                    None if nmask is None else nmask[lo:hi],
                    copy=rep.graphs is None)
                ts = timer.now()
                if rep.graphs is None:
                    out = mapping_step(
                        p, ln, rep.didx, m.k, m.w, pad, slots, nmask=nm,
                        clen=rep.clen, z=m._chain_z, runs=m.runs_only,
                        with_hashes=m.with_hashes,
                    )
                else:
                    out = rep.graphs.run(
                        mapping_step, dict(packed=p, lengths=ln, nmask=nm),
                        dict(index=rep.didx, k=m.k, w=m.w, L=pad,
                             slots=slots, clen=rep.clen, z=m._chain_z,
                             runs=m.runs_only, with_hashes=m.with_hashes))
                timer.mark("dispatch", ts)
                rep.launches += sketch_cuda.launches - launches
                if stream.counting:
                    join["slots"] += (hi - lo) * slots
                    join["bucket_bytes"] += ((hi - lo) * slots
                                             * rep.didx.max_probes
                                             * BUCKET_BYTES)
                blocks.append((*stream.download(out), lo, hi))
        return blocks

    def payload(self, stream: "_ReadBatches", flat: np.ndarray, B: int,
                slots: int):
        """(count, n_mins, planes) of a block of B rows."""
        m = self.mapper
        count, n_mins = flat[:B], flat[B : 2 * B]
        if stream.counting and not m.runs_only:
            m.join_stats["queries"] += int(np.minimum(n_mins, slots).sum())
        lanes = B * (RUN_LANES if m.runs_only else slots)
        return count, n_mins, flat[2 * B :].reshape(-1, lanes)


class _HashGrid:
    """The hash-sharded layout's steps: the table sharded over a (data,
    idx) grid of the devices (`parallel.sharded_index`), one step a pad,
    made at its first batch, whose payload comes back whole from the
    grid's first device. It chains on the host and counts no join."""

    counts_join = False

    def __init__(self, m: TorchMapper):
        self.mapper = m
        self.didx = ShardedDeviceIndex.from_contig_index(m.index,
                                                         m.idx_shards)
        self.mesh = make_mesh_2d(m.idx_shards, m.devices)
        self.text = (f"index hash-sharded over a {len(self.mesh)} x "
                     f"{m.idx_shards} (data, idx) grid of "
                     f"{[str(d) for d in m.devices]}")
        #: padded length -> its step
        self.steps: Dict[int, object] = {}
        #: whether the steps replay graphs: decided when the mapper is
        #: made, as a replica's are, though a step is made at its pad's
        #: first batch
        self.graphs = not tracing.profiling()

    def graph_sets(self) -> list:
        return [g for step in self.steps.values() for g in step.graphs]

    def launches(self) -> List[int]:
        # every cell launches once per batch
        return [self.mapper.kernel_launches]

    def run(self, stream: "_ReadBatches", pad: int, slots: int, packed,
            nmask, lengths, n_rows: int) -> list:
        step = self.steps.get(pad)
        if step is None:  # the pad's first batch
            m = self.mapper
            step = self.steps[pad] = make_sharded_index_mapping_step(
                self.mesh, self.didx, m.k, m.w, pad, slots,
                with_hashes=m.with_hashes,
            )
            if not self.graphs:
                step.graphs = [None] * len(step.graphs)
        origin = step.cells[0][0]
        B = len(lengths)
        # the step uploads each device's rows once (into its graph's
        # static inputs, or eagerly)
        p, ln, nm = stream.upload(origin.device, packed, lengths, nmask,
                                  copy=False, rows=step.grid.upload_rows(B))
        ts = stream.timer.now()
        flat = step.flat(p, ln, nm)
        stream.timer.mark("dispatch", ts)
        with origin.work():
            return [(*stream.download(flat), 0, B)]

    def payload(self, stream: "_ReadBatches", flat: np.ndarray, B: int,
                slots: int):
        """(count, n_mins, planes): meta in row 0, then the planes, with
        (cid, cpos) packed into one gpos plane when the index packs
        positions."""
        count, n_mins = flat[0, :B], flat[0, B : 2 * B]
        planes = list(flat[1:])
        if self.didx.t_off is not None:
            cid, cpos = self.didx.decode_gpos(planes[1][: int(count.sum())])
            planes[1:2] = [cid, cpos]
        return count, n_mins, planes


class _ReadBatches(BatchStream):
    """One read stream of a `TorchMapper` (`map_stream_raw`'s body), keyed
    in `timer`: on the producer thread reader_pull (per block),
    host_remap, pack, feed_enqueue_wait, flush_join; on the feeder
    h2d_put, dispatch, copy_back, drain_enqueue_wait; on the drainer
    drain_flat_wait, drain_decode. An item is a read; a row's tag is its
    read's index."""

    def __init__(self, mapper: TorchMapper, timer: PhaseTimer):
        depth = int(os.environ.get("NTLINK_PIPE_DEPTH", mapper.DEPTH))
        super().__init__(mapper, depth, "ntlink-torch-map", timer,
                         mapper.wire_stats)
        self.mapper = mapper
        #: the Tracer is on: the stream counts its join and its decode
        self.counting = tracing.GLOBAL.enabled

    def run(self, blocks):
        """Yield (name, length, raw) of every read of `blocks`, in order.

        A read the device takes joins its bucket; one it does not is
        mapped on the host when its turn comes. A block's reads are taken
        in segments that end at the first read where a bucket fills or
        the budget runs out, so each flush falls on the read it would fall
        on one read at a time, whatever the blocks' bounds."""
        m, timer = self.mapper, self.timer
        names, lengths, results = self.names, self.lengths, self.results
        if timer.on:
            blocks = timer.timed(blocks, "reader_pull")
        try:
            for block in blocks:
                m.read_blocks += 1
                n = len(block)
                lens = np.diff(block.offsets)
                device = (lens >= m.k) & (lens <= self.max_pad)
                log_pad = self.pad_log2(lens)
                bucket_of = np.where(device, 2 * log_pad + block.has_n, -1)
                pads = np.where(device, np.left_shift(1, log_pad), 0)
                block_names, block_lens = block.names, lens.tolist()
                block_rows = block.rows()
                s = 0
                while s < n:
                    seg = bucket_of[s:]
                    filled = np.cumsum(pads[s:])
                    # the last read of the segment: the budget's crossing,
                    # a bucket's filling, or the block's end
                    over = np.flatnonzero(filled >= self.limit - self.budget)
                    e = int(over[0]) if len(over) else n - s - 1
                    found, first = np.unique(seg, return_index=True)
                    order = np.argsort(first)
                    per_code = []
                    for code, at in zip(found[order].tolist(),
                                        first[order].tolist()):
                        pos = np.flatnonzero(seg == code)
                        if code >= 0:
                            need = self.room(code)
                            if len(pos) >= need:
                                e = min(e, int(pos[need - 1]))
                        per_code.append((code, at, pos))
                    base = len(names)
                    names.extend(block_names[s : s + e + 1])
                    lengths.extend(block_lens[s : s + e + 1])
                    seg_rows = block_rows[s : s + e + 1]
                    flushed = False
                    for code, at, pos in per_code:
                        if at > e:
                            break
                        taken = pos[: np.searchsorted(pos, e, "right")]
                        rows = list(map(seg_rows.__getitem__,
                                        taken.tolist()))
                        taken = (taken + base).tolist()
                        if code < 0:
                            for i, codes in zip(taken, rows):
                                results[i] = _Remap(codes)
                        else:
                            flushed = self.add(code, taken, rows) or flushed
                    self.budget += int(filled[e])
                    s += e + 1
                    if flushed:
                        yield from self.ready()
                    if self.budget >= self.limit:
                        yield from self.flush_all()
                yield from self.ready()
            yield from self.flush_all()
        finally:
            self.pipe.close()

    def take(self, raw):
        if isinstance(raw, _Remap):
            ts = self.timer.now()
            raw = self.mapper._host_map_raw(raw.codes)
            self.timer.mark("host_remap", ts)
        else:
            self.mapper.device_reads += 1
        return raw

    def step(self, key, packed, nmask, lengths, n_rows: int):
        m = self.mapper
        slots = m._slots_for(key[0])
        m.batches_by_pad[key] = m.batches_by_pad.get(key, 0) + 1
        return slots, m._steps.run(self, key[0], slots, packed, nmask,
                                   lengths, n_rows)

    def decode(self, flat, slots, lo, hi, tags, rows) -> None:
        """Batch rows lo..hi-1 (rows 0.. of this block's payload; rows past
        the batch's tags are padding). The block's anchors are decoded
        once, over the whole block, and each read's result holds its
        slices of those arrays: views, which no consumer writes into."""
        m = self.mapper
        count, n_mins, planes = m._steps.payload(self, flat, hi - lo, slots)
        offs = np.zeros(len(count) + 1, np.int64)
        np.cumsum(count, out=offs[1:])
        total = int(offs[-1])
        n = min(hi, len(tags)) - lo
        # run-lane overflow reports RUN_LANES + 1 in n_mins
        over = n_mins[:n] > (RUN_LANES if m.runs_only else slots)
        bare = count[:n] == 0
        remap = (np.flatnonzero(over) + lo).tolist()
        empty = (np.flatnonzero(bare & ~over) + lo).tolist()
        full = np.flatnonzero(~(bare | over))
        results = self.results
        for row in remap:
            results[tags[row]] = _Remap(rows[row])
        results.update(dict.fromkeys(map(tags.__getitem__, empty)))
        spans = zip(offs[full].tolist(), offs[full + 1].tolist())
        full_tags = map(tags.__getitem__, (full + lo).tolist())
        if m.runs_only:
            cid, cnt, f_cpos, l_cpos, f_rw, l_rw = (p[:total]
                                                    for p in planes[:6])
            runs = np.stack([
                cid, cnt, f_cpos, f_rw & 0x1FFFFFFF, (f_rw >> 29) & 3,
                l_cpos, l_rw & 0x1FFFFFFF, (l_rw >> 29) & 3,
            ], axis=1)
            results.update(zip(full_tags, (
                (e - o, runs[o:e]) for o, e in spans)))
        else:
            rw, cid, cpos = (p[:total] for p in planes[:3])
            rpos, sbits = rw & 0x1FFFFFFF, (rw >> 29) & 3
            if m.with_hashes:
                hs, ls = planes[3][:total], planes[4][:total]
            else:
                hs = ls = np.zeros(total, np.int32)
            results.update(zip(full_tags, (
                (e - o, rpos[o:e], cid[o:e], cpos[o:e], sbits[o:e], hs[o:e],
                 ls[o:e]) for o, e in spans)))
        if self.counting:
            stats = m.decode_stats
            stats["blocks"] += 1
            stats["rows"] += len(full)
            stats["remaps"] += len(remap)
            stats["empty"] += len(empty)
