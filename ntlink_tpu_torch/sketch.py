"""Batched contig sketching on one torch device.

Counterpart of ``ntlink_tpu/ops/sketch_jax.py::JaxSketcher`` (:367-688):
the `sketch_stream` backend that ``ntlink_tpu.sketch.sketch_sequences``
hands a FASTA to (``sketch_fasta_to_tsv(..., backend=TorchSketcher(...))``
writes the contig sketch TSV). Sequences stream into (pad, has_n) buckets
of ~16 M bases; one `mapping_step.sketch_step` per batch sketches them (the
Hopper kernel on a CUDA device; N rows take their windows again over the
valid k-mers) and ships only the minimizers.

Sequences longer than MAX_PAD split into window-aligned chunks: chunk c
computes windows [c*S, (c+1)*S) of the whole sequence, S = MAX_PAD -
(k + w - 2), and `merged` re-applies the one cross-chunk coupling, the
consecutive-winner dedup at a chunk's first window. Sub-k rows, oversized
rows with N and slot-overflow rows are sketched exactly on the host (the
native C sketcher) and counted in `host_fallbacks`.

`TorchHybridSketcher` (backend=hybrid) runs a TorchSketcher and the native
C thread pool at once over one stream, with ``HybridSketcher``'s scheduler
and quanta; both paths are exact, so the split changes speed, not bytes.
"""
from __future__ import annotations

import inspect
import sys
import time
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np

from ntlink_tpu.device_map import DeviceMapper
from ntlink_tpu.ops import nthash_np
from ntlink_tpu.ops.nthash_np import Minimizers
from ntlink_tpu.hybrid_map import HybridStream
from ntlink_tpu.sketch import (
    HybridSketcher,
    _DeviceSketchPath,
    _HostSketchPath,
    sketch_sequences,
)
from ntlink_tpu.stream_pipeline import DevicePipeline, next_pow2

from . import device as device_mod
from .device_map import batch_rows, copy_back, pack_batch, to_device
from .mapping_step import sketch_step
from .ops import sketch_cuda


def _empty() -> Minimizers:
    return Minimizers(np.zeros(0, np.uint64), np.zeros(0, np.int64),
                      np.zeros(0, bool))


class _Resketch:
    """A device row that overflowed its slot budget: the consumer thread
    sketches its codes on the exact host path when the row's turn comes
    and shifts the positions by the chunk's offset."""

    __slots__ = ("codes", "base_off")

    def __init__(self, codes: np.ndarray, base_off: int):
        self.codes, self.base_off = codes, base_off


class TorchSketcher:
    """`sketch_stream` backend on one torch device (``JaxSketcher``'s
    contract and constants)."""

    MIN_PAD = 1 << 10
    MAX_PAD = 1 << 21
    MAX_SLOTS = 1 << 17

    _pad_len = DeviceMapper._pad_len

    def __init__(self, device=None, batch_bases: int = 16_000_000):
        self.device = device_mod.resolve(device)
        self.batch_bases = batch_bases
        #: rows sketched exactly on the host (sub-k, oversized with N, or
        #: minimizer-slot overflow)
        self.host_fallbacks = 0
        #: device rows (whole sequences and chunks) and chunked sequences
        self.device_rows = 0
        self.chunked = 0
        #: device batches dispatched, by (padded row length, has N)
        self.batches_by_pad: Dict[Tuple[int, bool], int] = {}
        #: sketch kernel launches of every stream so far
        self.kernel_launches = 0
        #: wall seconds of every stream so far
        self.stream_seconds = 0.0

    def _slots_for(self, L: int, w: int) -> int:
        want = int(2.5 * L / (w + 1)) + 64
        s = 128
        while s < want and s < self.MAX_SLOTS:
            s <<= 1
        return s

    def _host_sketch(self, codes: np.ndarray, k: int, w: int) -> Minimizers:
        """Exact host sketch (``ntlink_tpu.sketch``'s host backend: the
        native C sketcher, NumPy without it)."""
        self.host_fallbacks += 1
        return next(sketch_sequences(iter([("", codes)]), k, w))[2]

    def sketch_stream(
        self, named_seqs: Iterable[Tuple[str, object]], k: int, w: int,
    ) -> Iterator[Tuple[str, int, Minimizers]]:
        """Yield (name, length, Minimizers) in input order."""
        launches0 = sketch_cuda.launches
        fallbacks0 = self.host_fallbacks
        n_seqs = 0
        t0 = time.perf_counter()
        pending: List[Tuple[str, int]] = []   # (name, length)
        #: per-chunk outputs, keyed (seq_idx, chunk_idx)
        results: Dict[Tuple[int, int], Minimizers] = {}
        encoded: Dict[Tuple[int, int], np.ndarray] = {}
        #: (pad, has_n) -> [(seq_idx, chunk_idx, base_offset), ...]
        buckets: Dict[tuple, List[tuple]] = {}
        n_chunks: Dict[int, int] = {}  # seq_idx -> chunk count (1 = whole)
        next_yield = [0]

        def flush_bucket(key: tuple, idxs: List[tuple]) -> None:
            pad, has_n = key
            # partial flushes step the height down to the next power of two
            B = min(batch_rows(pad, self.batch_bases), next_pow2(len(idxs)))
            row_codes = [encoded.pop((i, ci)) for i, ci, _ in idxs]
            lengths = np.zeros(B, dtype=np.int32)
            lengths[: len(idxs)] = [len(c) for c in row_codes]
            packed, nmask = pack_batch(row_codes, B, pad, has_n)
            pipe.submit((packed, nmask, lengths, key, dict(enumerate(idxs)),
                         row_codes))

        def dispatch(packed, nmask, lengths, key, rows, row_codes) -> None:
            pad = key[0]
            slots = self._slots_for(pad, w)
            self.batches_by_pad[key] = self.batches_by_pad.get(key, 0) + 1
            p, ln, nm = to_device(self.device, packed, lengths, nmask)
            out = sketch_step(p, ln, k, w, pad, slots, nmask=nm)
            pipe.submit_drain((*copy_back(out), len(lengths), slots, rows,
                               row_codes))

        def drain(out, event, B, slots, rows, row_codes) -> None:
            if event is not None:
                event.synchronize()
            flat = out.numpy()
            count, n_mins = flat[:B], flat[B : 2 * B]
            planes = flat[2 * B :].reshape(3, B * slots)
            offs = np.zeros(B + 1, np.int64)
            np.cumsum(count, out=offs[1:])
            for row, (i, ci, base_off) in rows.items():
                n = int(count[row])
                if n_mins[row] > slots:
                    results[(i, ci)] = _Resketch(row_codes[row], base_off)
                    continue
                self.device_rows += 1
                if n == 0:
                    results[(i, ci)] = _empty()
                    continue
                o = int(offs[row])
                ps = planes[0, o : o + n]
                hashes = (
                    planes[1, o : o + n].view(np.uint32).astype(np.uint64)
                    << np.uint64(32)
                ) | planes[2, o : o + n].view(np.uint32).astype(np.uint64)
                results[(i, ci)] = Minimizers(
                    hashes, (ps & 0x3FFFFFFF).astype(np.int64) + base_off,
                    (ps >> 30).astype(bool),
                )

        pipe = DevicePipeline(dispatch, drain, name="ntlink-torch-sketch")

        def take(i: int, ci: int) -> Minimizers:
            m = results.pop((i, ci))
            if isinstance(m, _Resketch):
                h = self._host_sketch(m.codes, k, w)
                m = Minimizers(h.hashes, h.positions + m.base_off, h.forward)
            return m

        def merged(i: int) -> Minimizers:
            nc = n_chunks.pop(i)
            if nc == 1:
                return take(i, 0)
            # the whole-sequence sketch emits at window j iff winner(j) !=
            # winner(j-1); a chunk's first window always emits, so drop it
            # iff it equals the previous chunk's last-window winner, which
            # is that chunk's last emitted minimizer before its own trim
            hs, ps, fs = [], [], []
            prev_last = -1
            for ci in range(nc):
                m = take(i, ci)
                h, po, f = m.hashes, m.positions, m.forward
                if len(po) and len(ps) and int(po[0]) == prev_last:
                    h, po, f = h[1:], po[1:], f[1:]
                if len(m.positions):
                    prev_last = int(m.positions[-1])
                hs.append(h)
                ps.append(po)
                fs.append(f)
            return Minimizers(
                np.concatenate(hs), np.concatenate(ps), np.concatenate(fs)
            )

        def have_all(i: int) -> bool:
            return all((i, ci) in results for ci in range(n_chunks[i]))

        def deliver(i: int):
            name, length = pending[i]
            pending[i] = None
            return name, length, merged(i)

        def ready_results():
            # in input order, as soon as every chunk of a sequence has
            # drained (the drainer only adds keys; this thread pops)
            i = next_yield[0]
            while i < len(pending) and have_all(i):
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

        def enqueue(i: int, ci: int, codes: np.ndarray, off: int,
                    has_n: bool) -> int:
            """Bucket one device row; returns its padded length."""
            encoded[(i, ci)] = codes
            pad = self._pad_len(len(codes))
            key = (pad, has_n)
            bucket = buckets.setdefault(key, [])
            bucket.append((i, ci, off))
            if len(bucket) >= batch_rows(pad, self.batch_bases):
                flush_bucket(key, bucket)
                buckets[key] = []
            return pad

        try:
            budget = 0
            for name, seq in named_seqs:
                n_seqs += 1
                i = len(pending)
                pending.append((name, len(seq)))
                codes = (
                    seq if isinstance(seq, np.ndarray)
                    else nthash_np.encode(seq)
                )
                has_n = bool((codes > 3).any())
                n_chunks[i] = 1
                if len(codes) < k or (len(codes) > self.MAX_PAD and has_n):
                    # chunk seams do not compose with the windows over
                    # valid k-mers, so oversized N rows stay on the host
                    results[(i, 0)] = self._host_sketch(codes, k, w)
                elif len(codes) > self.MAX_PAD:
                    S = self.MAX_PAD - (k + w - 2)
                    M = len(codes) - (k + w - 2)  # windows in all
                    nc = (M + S - 1) // S
                    n_chunks[i] = nc
                    self.chunked += 1
                    for ci in range(nc):
                        lo = ci * S
                        hi = min(lo + S, M) + (k + w - 2)
                        budget += enqueue(i, ci, codes[lo:hi], lo, False)
                else:
                    budget += enqueue(i, 0, codes, 0, has_n)
                yield from ready_results()
                if budget >= 4 * self.batch_bases:
                    yield from flush_all()
                    budget = 0
            yield from flush_all()
        finally:
            pipe.close()
            secs = time.perf_counter() - t0
            self.stream_seconds += secs
            self.kernel_launches += sketch_cuda.launches - launches0
            print(
                f"# ntlink_tpu_torch sketch ({self.device}): {n_seqs} "
                f"sequence(s) in {secs:.3f} s; "
                f"{sketch_cuda.launches - launches0} sketch kernel "
                f"launch(es); so far {self.device_rows} device row(s), "
                f"{self.chunked} chunked sequence(s), batches by (pad, has "
                f"N) {self.batches_by_pad}; "
                f"{self.host_fallbacks - fallbacks0} row(s) of this stream "
                f"on the exact host path (sub-k, oversized with N, or "
                f"slot overflow)",
                file=sys.stderr,
            )


#: HybridSketcher's assignment quanta (items and bases per block)
_HYBRID_QUANTA = inspect.signature(HybridSketcher).parameters


class TorchHybridSketcher:
    """`sketch_stream` backend that splits the sequences between a
    TorchSketcher and the native C thread pool (``HybridSketcher``'s
    contract and quanta; that class cannot be reused, its constructor
    imports the JAX sketcher)."""

    def __init__(self, device=None, threads: int = 4,
                 host_frac: float = -1.0):
        self.device_backend = TorchSketcher(device)
        self.threads = max(1, threads)
        self.host_frac = host_frac
        #: sequences each path delivered in the latest stream
        self.host_seqs = 0
        self.device_seqs = 0

    def sketch_stream(self, named_seqs, k: int, w: int):
        sched = HybridStream(
            _DeviceSketchPath(self.device_backend, k, w),
            _HostSketchPath(k, w, self.threads),
            host_frac=self.host_frac,
        )
        sched.BLOCK_READS = _HYBRID_QUANTA["block_items"].default
        sched.BLOCK_BASES = _HYBRID_QUANTA["block_bases"].default
        try:
            yield from sched.stream(named_seqs)
        finally:
            self.host_seqs = sched.host_reads
            self.device_seqs = sched.device_reads
