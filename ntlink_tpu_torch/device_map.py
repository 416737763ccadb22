"""Batched read mapping on one device: sketch + index join in PyTorch.

Counterpart of ``ntlink_tpu/device_map.py::DeviceMapper`` with on-device
chaining off and no hash planes. Reads stream into length-bucketed, 2-bit
packed (B, pad/4) batches; one `mapping_step.mapping_step` per batch sketches
them (the Hopper kernel on a CUDA device), joins the minimizers against the
contig table and compacts the matched anchors. The host then chains them in
C (``ntlink_tpu.pipeline._map_reads_native`` with prechained=0).

Reads the device does not take go to the exact host path
(``DeviceMapper._host_map_raw``: native C sketch + sorted-index join) and
are counted in `host_fallbacks`: sub-k reads, reads over MAX_PAD, reads
with a non-ACGT base, and reads whose minimizers overflow the slot budget.
Every path gives the same raw payload as ``DeviceMapper`` and
``HostMapper``.
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
from ntlink_tpu.stream_pipeline import DevicePipeline, next_pow2

from . import device as device_mod
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
                 batch_bases: int = 8_000_000, device=None):
        self.device = device_mod.resolve(device)
        index.finalize()
        self.index = index
        self.k, self.w = k, w
        self.batch_bases = batch_bases
        self.contig_names: List[str] = index.contig_names
        self._contig_order = {n: i for i, n in enumerate(index.contig_names)}
        self.prechained = False
        self.runs_only = False
        self.didx = DeviceIndex.from_contig_index(index, self.device)
        self.host_fallbacks = 0
        #: reads whose anchors came from a device batch
        self.device_reads = 0
        #: device batches dispatched, by padded row length
        self.batches_by_pad: Dict[int, int] = {}
        #: wall seconds of every read stream so far (the summary line's)
        self.stream_seconds = 0.0

    def map_stream_raw(self, named_seqs: Iterable[Tuple[str, object]]):
        """Yield (read_name, read_len, raw) in input order; raw is None or
        (n, rpos, cid, cpos, sbits, hi, lo) int32 arrays (hi = lo = 0 on
        device rows: no hash planes without the repeat filter)."""
        from ntlink_tpu.native import fastx_module

        native = fastx_module()
        on_cuda = self.device.type == "cuda"
        launches0 = sketch_cuda.launches
        reads0 = self.device_reads + self.host_fallbacks
        t0 = time.perf_counter()
        pending: List[Tuple[str, int]] = []   # (name, length)
        results: Dict[int, object] = {}
        encoded: Dict[int, np.ndarray] = {}
        buckets: Dict[int, List[int]] = {}    # pad -> read idxs
        next_yield = [0]

        def flush_bucket(pad: int, idxs: List[int]) -> None:
            # partial flushes step the height down to the next power of two
            B = min(batch_rows(pad, self.batch_bases), next_pow2(len(idxs)))
            row_codes = [encoded.pop(i) for i in idxs]
            lengths = np.zeros(B, dtype=np.int32)
            lengths[: len(idxs)] = [len(c) for c in row_codes]
            if native is not None:
                buf = native.pack_batch(row_codes, pad)
                packed = np.frombuffer(buf, np.uint8).reshape(-1, pad // 4)
                if packed.shape[0] < B:
                    packed = np.vstack([
                        packed,
                        np.zeros((B - packed.shape[0], pad // 4), np.uint8),
                    ])
            else:
                codes = np.zeros((B, pad), dtype=np.uint8)
                for row, c in enumerate(row_codes):
                    codes[row, : len(c)] = c
                packed = pack_codes(codes)
            pipe.submit((packed, lengths, pad, dict(enumerate(idxs)),
                         row_codes))

        def to_device(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
            # one host copy, straight into pinned memory on a CUDA run
            t = torch.empty(a.shape, dtype=dtype, pin_memory=on_cuda)
            t.numpy()[...] = a
            return t.to(self.device, non_blocking=True) if on_cuda else t

        def dispatch(packed, lengths, pad, rows, row_codes) -> None:
            # feeder thread: every device call of the batch; the copy back
            # lands in pinned memory, and the event marks its end
            slots = self._slots_for(pad)
            self.batches_by_pad[pad] = self.batches_by_pad.get(pad, 0) + 1
            out = mapping_step(
                to_device(packed, torch.uint8),
                to_device(lengths, torch.int32), self.didx,
                self.k, self.w, pad, slots,
            )
            event = None
            if on_cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                out = host
            pipe.submit_drain((out, event, len(lengths), slots, rows,
                               row_codes))

        def drain(out, event, B, slots, rows, row_codes) -> None:
            if event is not None:
                event.synchronize()
            flat = out.numpy()
            count, n_mins = flat[:B], flat[B : 2 * B]
            planes = flat[2 * B :].reshape(3, B * slots)
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
                rw = planes[0, o : o + n]
                zeros = np.zeros(n, np.int32)
                results[i] = (
                    n, rw & 0x1FFFFFFF, planes[1, o : o + n],
                    planes[2, o : o + n], (rw >> 29) & 3, zeros, zeros,
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
            for pad, idxs in list(buckets.items()):
                if idxs:
                    flush_bucket(pad, idxs)
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
                if (
                    len(codes) < self.k
                    or len(codes) > self.MAX_PAD
                    or bool((codes > 3).any())
                ):
                    results[i] = _Remap(codes)
                    yield from ready_results()
                    continue
                encoded[i] = codes
                pad = self._pad_len(len(codes))
                bucket = buckets.setdefault(pad, [])
                bucket.append(i)
                if len(bucket) >= batch_rows(pad, self.batch_bases):
                    flush_bucket(pad, bucket)
                    buckets[pad] = []
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
            n = self.device_reads + self.host_fallbacks - reads0
            print(
                f"# ntlink_tpu_torch device-map ({self.device}): {n} "
                f"read(s) in {secs:.3f} s ({n / max(secs, 1e-9):.1f} "
                f"reads/s); {sketch_cuda.launches - launches0} sketch "
                f"kernel launch(es); so far {self.device_reads} read(s) "
                f"on the device, batches by pad {self.batches_by_pad}, and "
                f"{self.host_fallbacks} on the exact host path (sub-k, "
                f"> {self.MAX_PAD} bases, non-ACGT base or slot overflow)",
                file=sys.stderr,
            )
