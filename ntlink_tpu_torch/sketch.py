"""Batched contig sketching on one torch device.

Counterpart of ``ntlink_tpu/ops/sketch_jax.py::JaxSketcher`` (:367-688):
the `sketch_stream` backend that `sketch_sequences` hands a FASTA to
(``sketch_fasta_to_tsv(..., backend=TorchSketcher(...))`` writes the contig
sketch TSV); the host half of ``ntlink_tpu/sketch.py`` (the host backend,
the hybrid paths and the TSV dialects) is here too. Sequences stream into (pad, has_n) buckets
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

import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np

from . import device as device_mod
from .device_map import TorchMapper, batch_rows, copy_back, pack_batch, to_device
from .hybrid_map import HybridStream
from .mapping_step import sketch_step
from .native import fastx_module, sketch_module
from .ops import nthash_np, sketch_cuda
from .ops.nthash_np import Minimizers
from .seqio import stream_fastx
from .stream_pipeline import DevicePipeline, next_pow2


def sketch_sequences(
    named_seqs: Iterable[Tuple[str, str]],
    k: int,
    w: int,
    backend=None,
    threads: int = 1,
) -> Iterator[Tuple[str, int, Minimizers]]:
    """Yield (name, seq_len, Minimizers) per input sequence.

    `threads` > 1 (host backend only) runs the native C rolling sketcher
    over a thread pool — it releases the GIL, so this is real CPU
    parallelism (the stand-in for btllib indexlr's `-t`, ntLink:199).
    Output order is preserved."""
    if backend is None:
        def to_codes(seq):
            # payloads may arrive pre-encoded (HybridSketcher paths)
            return seq if isinstance(seq, np.ndarray) else nthash_np.encode(seq)

        sm = sketch_module()
        if sm is not None:
            # native rolling sketcher (bit-exact vs nthash_np; ~6x the
            # vectorized NumPy hasher at assembly scale)

            def decode(res, n):
                _, hb, pb, fb = res
                return n, Minimizers(
                    np.frombuffer(hb, np.uint64),
                    np.frombuffer(pb, np.int64),
                    np.frombuffer(fb, np.uint8).astype(bool),
                )

            if threads > 1:
                def job(item):
                    name, seq = item
                    return name, decode(
                        sm.sketch(to_codes(seq), k, w), len(seq)
                    )

                with ThreadPoolExecutor(max_workers=threads) as pool:
                    # bounded in-flight window (2x threads): keeps every
                    # core fed without materializing the whole input (a
                    # genome's worth of sequence) in memory; FIFO pops
                    # preserve input order
                    inflight = deque()
                    for item in named_seqs:
                        inflight.append(pool.submit(job, item))
                        if len(inflight) >= 2 * threads:
                            name, (n, mins) = inflight.popleft().result()
                            yield name, n, mins
                    while inflight:
                        name, (n, mins) = inflight.popleft().result()
                        yield name, n, mins
                return
            for name, seq in named_seqs:
                n, mins = decode(sm.sketch(to_codes(seq), k, w), len(seq))
                yield name, n, mins
            return
        for name, seq in named_seqs:
            yield name, len(seq), nthash_np.sketch_codes(to_codes(seq), k, w)
    else:
        yield from backend.sketch_stream(named_seqs, k, w)


class _DeviceSketchPath:
    """Adapt a device sketch backend to the HybridStream path interface."""

    def __init__(self, backend, k: int, w: int):
        self.backend, self.k, self.w = backend, k, w

    def map_stream_raw(self, named_codes):
        yield from self.backend.sketch_stream(named_codes, self.k, self.w)


class _HostSketchPath:
    """Threaded native-C sketch path (HybridStream interface)."""

    def __init__(self, k: int, w: int, threads: int):
        self.k, self.w, self.threads = k, w, threads

    def map_stream_raw(self, named_codes):
        def to_seq(codes):
            if isinstance(codes, np.ndarray):
                return codes
            return nthash_np.encode(codes)

        yield from sketch_sequences(
            ((name, to_seq(c)) for name, c in named_codes),
            self.k,
            self.w,
            threads=self.threads,
        )



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

    _pad_len = TorchMapper._pad_len

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
        """Exact host sketch (`sketch_sequences`' host backend: the
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


#: the hybrid sketcher's assignment quanta: a block is ~one device bucket
#: of bases; the item quantum keeps streams of many small sequences
#: splitting (``HybridSketcher``'s `block_items` and `block_bases`)
HYBRID_BLOCK_ITEMS = 64
HYBRID_BLOCK_BASES = 16_000_000


class TorchHybridSketcher:
    """`sketch_stream` backend that splits the sequences between a
    TorchSketcher and the native C thread pool (``HybridSketcher``'s
    contract and quanta)."""

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
        sched.BLOCK_READS = HYBRID_BLOCK_ITEMS
        sched.BLOCK_BASES = HYBRID_BLOCK_BASES
        try:
            yield from sched.stream(named_seqs)
        finally:
            self.host_seqs = sched.host_reads
            self.device_seqs = sched.device_reads


def format_minimizers_bytes(mins: Minimizers, with_strand: bool = True) -> bytes:
    """Render the indexlr TSV body ("hash:pos[:strand] ..."); native C
    renderer when available (~30x at assembly scale), Python fallback."""
    native = fastx_module()
    if native is not None and hasattr(native, "render_minimizers"):
        return native.render_minimizers(
            np.ascontiguousarray(mins.hashes),
            np.ascontiguousarray(mins.positions.astype(np.int64)),
            np.ascontiguousarray(mins.forward).view(np.uint8)
            if with_strand
            else None,
            len(mins.hashes),
        )
    return format_minimizers(mins, with_strand=with_strand).encode()


def format_minimizers(mins: Minimizers, with_strand: bool = True) -> str:
    if with_strand:
        return " ".join(
            f"{h}:{p}:{'+' if f else '-'}"
            for h, p, f in zip(mins.hashes, mins.positions, mins.forward)
        )
    return " ".join(f"{h}:{p}" for h, p in zip(mins.hashes, mins.positions))


def write_sketch_tsv(
    out_fh,
    named_seqs: Iterable[Tuple[str, str]],
    k: int,
    w: int,
    with_strand: bool = True,
    with_len: bool = False,
    backend=None,
    threads: int = 1,
) -> None:
    """Stream sequences through the sketcher, writing indexlr-style TSV
    (binary file handle)."""
    for name, seq_len, mins in sketch_sequences(
        named_seqs, k, w, backend=backend, threads=threads
    ):
        body = format_minimizers_bytes(mins, with_strand=with_strand)
        if with_len:
            out_fh.write(f"{name}\t{seq_len}\t".encode() + body + b"\n")
        else:
            out_fh.write(f"{name}\t".encode() + body + b"\n")


def sketch_fasta_to_tsv(
    fasta_path: str,
    out_path: str,
    k: int,
    w: int,
    with_strand: bool = True,
    with_len: bool = False,
    backend=None,
    threads: int = 1,
) -> None:
    # crash-safe artifact write (tmp + atomic rename): a killed run must
    # not leave a truncated TSV that a later run's mtime-freshness check
    # would silently reuse as a complete sketch
    tmp = f"{out_path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as out_fh:
            write_sketch_tsv(
                out_fh,
                ((rec.name, rec.seq) for rec in stream_fastx(fasta_path)),
                k,
                w,
                with_strand=with_strand,
                with_len=with_len,
                backend=backend,
                threads=threads,
            )
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
