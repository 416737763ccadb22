"""Batched read mapping on one device: sketch + index join in PyTorch.

Counterpart of ``ntlink_tpu/device_map.py::DeviceMapper`` on one device.
Reads stream into (pad, has_n)-bucketed, 2-bit packed
(B, pad/4) batches, N-containing reads with a 1-bit mask of their non-ACGT
bases (``stream_pipeline.split_n_rows``); one `mapping_step.mapping_step`
per batch sketches them (the Hopper kernel on a CUDA device), joins the
minimizers against the contig table and compacts the matched anchors.

Three payloads, with ``DeviceMapper``'s gates:

- per-anchor, host-chained (`prechain` None, or `with_hashes`): the host
  chains every read in C (``ntlink_tpu.pipeline._map_reads_native`` with
  prechained=0); `with_hashes` (repeats=True) ships each anchor's hash
  halves too, for the repeat filter that runs before chaining;
- per-anchor, prechained: the chaining acceptance stages run in the step
  (`chain.chain_anchors_device`) and only accepted anchors ship;
- O(runs) (`runs_only`, needs prechained): the step ships each read's
  merged runs, decoded here to chain.c's run rows [cid, count, f_cpos,
  f_rpos, f_sbits, l_cpos, l_rpos, l_sbits] for
  ``ntlink_tpu.pipeline._map_reads_runs``.

Reads the device does not take go to the exact host path
(``DeviceMapper._host_map_raw``: native C sketch + sorted-index join, then
chain.c for the prechained and runs payloads) and are counted in
`host_fallbacks`: sub-k reads, reads over MAX_PAD, and reads whose
minimizers overflow the slot budget or whose runs overflow RUN_LANES.
Every path gives the same raw payload as ``DeviceMapper`` and
``HostMapper`` with the same arguments.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from ntlink_tpu.device_map import DeviceMapper
from ntlink_tpu.index import ContigIndex
from ntlink_tpu.ops import nthash_np
from ntlink_tpu.stream_pipeline import DevicePipeline, next_pow2, split_n_rows

from . import device as device_mod
from .chain import CHAIN_MAX_CONTIGS, RUN_LANES
from .mapping_step import DeviceIndex, mapping_step, pack_codes
from .ops import sketch_cuda


class _Remap:
    """A read for the exact host path (one the device does not take, or a
    device row that overflowed its slot budget): the consumer thread maps
    its codes there when the read's turn comes."""

    __slots__ = ("codes",)

    def __init__(self, codes: np.ndarray):
        self.codes = codes


def batch_rows(pad: int, batch_bases: int) -> int:
    """Rows of a full device batch at padded length `pad`: the power of two
    nearest above batch_bases / pad (``DeviceMapper``'s batch height)."""
    return next_pow2(max(1, batch_bases // pad))


class TorchMapper:
    """Raw-payload read mapper on one torch device (``DeviceMapper``'s
    contract: `contig_names`, `_contig_order`, `prechained`, `runs_only`,
    `host_fallbacks`, `map_stream_raw`, `map_stream`)."""

    MIN_PAD = DeviceMapper.MIN_PAD
    MAX_PAD = DeviceMapper.MAX_PAD
    #: in-flight batches between the producer, feeder and drainer threads
    DEPTH = 4

    # the exact host path and the per-hit view are DeviceMapper's own code
    # (no JAX in either): payloads match by construction
    _host_map_raw = DeviceMapper._host_map_raw
    _pad_len = DeviceMapper._pad_len
    _slots_for = DeviceMapper._slots_for
    map_stream = DeviceMapper.map_stream

    def __init__(self, index: ContigIndex, k: int, w: int,
                 batch_bases: int = 8_000_000, device=None, prechain=None,
                 runs_only: bool = False, with_hashes: bool = False):
        self.device = device_mod.resolve(device)
        index.finalize()
        self.index = index
        self.k, self.w = k, w
        self.batch_bases = batch_bases
        self.contig_names: List[str] = index.contig_names
        self._contig_order = {n: i for i, n in enumerate(index.contig_names)}
        self.with_hashes = bool(with_hashes)
        # on-device chaining when `prechain` = (contig lengths in contig-id
        # order, z) and DeviceMapper's gates hold (no hash planes: the
        # repeat filter must run before chaining);
        # `_host_map_raw` reads `prechained`, `runs_only`, `_chain_sel` and
        # `_chain_z`, so fallback rows ship the same payload kind
        self.prechained = False
        self._clen_dev = None
        self._chain_z = 0
        self._chain_sel = None
        if (
            prechain is not None
            and not self.with_hashes
            and len(index.contig_names) <= CHAIN_MAX_CONTIGS
        ):
            from ntlink_tpu.native import chain_module

            cm = chain_module()
            if cm is not None:  # exact host chaining for fallback rows
                clen_arr, z = prechain
                clen_np = np.ascontiguousarray(clen_arr, dtype=np.int32)
                self._clen_dev = torch.from_numpy(clen_np).to(self.device)
                self._chain_z = int(z)
                self._chain_sel = cm.Chainer(clen_np, index.contig_names)
                self.prechained = True
        self.runs_only = bool(runs_only) and self.prechained
        self.didx = DeviceIndex.from_contig_index(index, self.device)
        self.host_fallbacks = 0
        #: reads whose anchors came from a device batch
        self.device_reads = 0
        #: device batches dispatched, by (padded row length, has N)
        self.batches_by_pad: Dict[Tuple[int, bool], int] = {}
        #: sketch kernel launches of every stream so far
        self.kernel_launches = 0
        #: wall seconds of every read stream so far (the summary line's)
        self.stream_seconds = 0.0

    def map_stream_raw(self, named_seqs: Iterable[Tuple[str, object]]):
        """Yield (read_name, read_len, raw) in input order. raw is None, or
        (n, rpos, cid, cpos, sbits, hi, lo) int32 arrays (hi = lo = 0 on
        device rows unless `with_hashes`), or with
        `runs_only` (n, runs) where runs is chain.c's (n, 8) int32 run
        rows."""
        launches0 = sketch_cuda.launches
        reads0 = self.device_reads + self.host_fallbacks
        t0 = time.perf_counter()
        pending: List[Tuple[str, int]] = []   # (name, length)
        results: Dict[int, object] = {}
        encoded: Dict[int, np.ndarray] = {}
        buckets: Dict[tuple, List[int]] = {}  # (pad, has_n) -> read idxs
        next_yield = [0]

        def flush_bucket(key: tuple, idxs: List[int]) -> None:
            pad, has_n = key
            # partial flushes step the height down to the next power of two
            B = min(batch_rows(pad, self.batch_bases), next_pow2(len(idxs)))
            row_codes = [encoded.pop(i) for i in idxs]
            lengths = np.zeros(B, dtype=np.int32)
            lengths[: len(idxs)] = [len(c) for c in row_codes]
            packed, nmask = pack_batch(row_codes, B, pad, has_n)
            pipe.submit((packed, nmask, lengths, key, dict(enumerate(idxs)),
                         row_codes))

        def dispatch(packed, nmask, lengths, key, rows, row_codes) -> None:
            # feeder thread: every device call of the batch
            pad = key[0]
            slots = self._slots_for(pad)
            self.batches_by_pad[key] = self.batches_by_pad.get(key, 0) + 1
            p, ln, nm = to_device(self.device, packed, lengths, nmask)
            out = mapping_step(
                p, ln, self.didx, self.k, self.w, pad, slots, nmask=nm,
                clen=self._clen_dev, z=self._chain_z, runs=self.runs_only,
                with_hashes=self.with_hashes,
            )
            pipe.submit_drain((*copy_back(out), len(lengths), slots, rows,
                               row_codes))

        def drain(out, event, B, slots, rows, row_codes) -> None:
            if event is not None:
                event.synchronize()
            flat = out.numpy()
            count, n_mins = flat[:B], flat[B : 2 * B]
            if self.runs_only:
                # run-lane overflow reports RUN_LANES + 1 in n_mins
                slots = RUN_LANES
                planes = flat[2 * B :].reshape(6, B * slots)
                total = int(count.sum())
                cid, cnt, f_cpos, l_cpos, f_rw, l_rw = planes[:, :total]
                runs = np.stack([
                    cid, cnt, f_cpos, f_rw & 0x1FFFFFFF, (f_rw >> 29) & 3,
                    l_cpos, l_rw & 0x1FFFFFFF, (l_rw >> 29) & 3,
                ], axis=1)
            else:
                planes = flat[2 * B :].reshape(-1, B * slots)
            offs = np.zeros(B + 1, np.int64)
            np.cumsum(count, out=offs[1:])
            for row, i in rows.items():
                n = int(count[row])
                if n_mins[row] > slots:
                    results[i] = _Remap(row_codes[row])
                    continue
                if n == 0:
                    results[i] = None
                    continue
                o = int(offs[row])
                if self.runs_only:
                    results[i] = (n, runs[o : o + n])
                    continue
                rw = planes[0, o : o + n]
                if self.with_hashes:
                    hi, lo = planes[3, o : o + n], planes[4, o : o + n]
                else:
                    hi = lo = np.zeros(n, np.int32)
                results[i] = (
                    n, rw & 0x1FFFFFFF, planes[1, o : o + n],
                    planes[2, o : o + n], (rw >> 29) & 3, hi, lo,
                )

        pipe = DevicePipeline(dispatch, drain, depth=self.DEPTH,
                              name="ntlink-torch-map")

        def deliver(i: int):
            name, length = pending[i]
            pending[i] = None
            raw = results.pop(i)
            if isinstance(raw, _Remap):
                raw = self._host_map_raw(raw.codes)
            else:
                self.device_reads += 1
            return name, length, raw

        def ready_results():
            # in input order, as soon as a read's batch has drained (the
            # drainer only adds keys; this thread pops)
            i = next_yield[0]
            while i < len(pending) and i in results:
                yield deliver(i)
                i += 1
            next_yield[0] = i

        def flush_all():
            for key, idxs in list(buckets.items()):
                if idxs:
                    flush_bucket(key, idxs)
            buckets.clear()
            pipe.join_all()
            for i in range(next_yield[0], len(pending)):
                yield deliver(i)
            pending.clear()
            results.clear()
            next_yield[0] = 0

        try:
            budget = 0
            for name, payload in named_seqs:
                i = len(pending)
                codes = (
                    payload if isinstance(payload, np.ndarray)
                    else nthash_np.encode(payload)
                )
                pending.append((name, len(codes)))
                if len(codes) < self.k or len(codes) > self.MAX_PAD:
                    results[i] = _Remap(codes)
                    yield from ready_results()
                    continue
                encoded[i] = codes
                pad = self._pad_len(len(codes))
                key = (pad, bool((codes > 3).any()))
                bucket = buckets.setdefault(key, [])
                bucket.append(i)
                if len(bucket) >= batch_rows(pad, self.batch_bases):
                    flush_bucket(key, bucket)
                    buckets[key] = []
                    yield from ready_results()
                budget += pad
                if budget >= 4 * self.batch_bases:
                    yield from flush_all()
                    budget = 0
            yield from flush_all()
        finally:
            pipe.close()
            secs = time.perf_counter() - t0
            self.stream_seconds += secs
            self.kernel_launches += sketch_cuda.launches - launches0
            n = self.device_reads + self.host_fallbacks - reads0
            mode = (
                "runs-only" if self.runs_only
                else "prechained" if self.prechained else "host-chained"
            )
            print(
                f"# ntlink_tpu_torch device-map ({self.device}, {mode}): {n} "
                f"read(s) in {secs:.3f} s ({n / max(secs, 1e-9):.1f} "
                f"reads/s); {sketch_cuda.launches - launches0} sketch "
                f"kernel launch(es); so far {self.device_reads} read(s) "
                f"on the device, batches by (pad, has N) "
                f"{self.batches_by_pad}, and {self.host_fallbacks} on the "
                f"exact host path (sub-k, > {self.MAX_PAD} bases, slot or "
                f"run-lane overflow)",
                file=sys.stderr,
            )


def to_device(device: torch.device, packed: np.ndarray,
              lengths: np.ndarray, nmask):
    """(packed uint8, lengths int32, nmask uint8 or None) on `device`: one
    host copy each, straight into pinned memory on a CUDA device, and an
    asynchronous upload."""
    on_cuda = device.type == "cuda"

    def put(a, dtype):
        t = torch.empty(a.shape, dtype=dtype, pin_memory=on_cuda)
        t.numpy()[...] = a
        return t.to(device, non_blocking=True) if on_cuda else t

    return (put(packed, torch.uint8), put(lengths, torch.int32),
            None if nmask is None else put(nmask, torch.uint8))


def copy_back(out: torch.Tensor):
    """Start the copy of a step's payload to the host: (host tensor, CUDA
    event marking the copy's end, or None on the CPU). The drainer waits
    on the event before it reads the host tensor."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def pack_batch(row_codes: List[np.ndarray], B: int, pad: int, has_n: bool):
    """Host side of a device batch: (packed (B, pad/4) uint8 2-bit codes,
    nmask (B, pad/8) bit-packed non-ACGT mask or None). Rows of a has_n
    batch are cleaned to A for packing (``split_n_rows``)."""
    from ntlink_tpu.native import fastx_module

    nmask = None
    if has_n:
        row_codes, nmask = split_n_rows(row_codes, B, pad)
    native = fastx_module()
    if native is not None:
        buf = native.pack_batch(row_codes, pad)
        packed = np.frombuffer(buf, np.uint8).reshape(-1, pad // 4)
        if packed.shape[0] < B:
            packed = np.vstack([
                packed, np.zeros((B - packed.shape[0], pad // 4), np.uint8),
            ])
        return packed, nmask
    codes = np.zeros((B, pad), dtype=np.uint8)
    for row, c in enumerate(row_codes):
        codes[row, : len(c)] = c
    return pack_codes(codes), nmask
