"""Batched contig sketching on one torch device.

Counterpart of ``ntlink_tpu/ops/sketch_jax.py::JaxSketcher`` (:367-688):
the `sketch_stream` backend that `sketch_sequences` hands a FASTA to
(``sketch_fasta_to_tsv(..., backend=TorchSketcher(...))`` writes the contig
sketch TSV); the host half of ``ntlink_tpu/sketch.py`` (the host backend,
the hybrid paths and the TSV dialects) is here too. Sequences stream into (pad, has_n) buckets
of ~16 M bases; one `mapping_step.sketch_step` per batch sketches them (the
Hopper kernel on a CUDA device; N rows take their windows again over the
valid k-mers) and ships only the minimizers. On a CUDA device a batch is
one CUDA graph replay of that step, captured once per static key
(``step_graph``, the counterpart of ``JaxSketcher``'s jitted step); on the
CPU and under a device profile the step runs eagerly.

Sequences longer than MAX_PAD split into window-aligned chunks: chunk c
computes windows [c*S, (c+1)*S) of the whole sequence, S = MAX_PAD -
(k + w - 2), and `merged` re-applies the one cross-chunk coupling, the
consecutive-winner dedup at a chunk's first window. Sub-k rows, oversized
rows with N and slot-overflow rows are sketched exactly on the host (the
native C sketcher) and counted in `host_fallbacks`.

`TorchHybridSketcher` runs a TorchSketcher and the native C thread pool at
once over one stream, with ``HybridSketcher``'s scheduler and quanta; both
paths are exact, so the split changes speed, not bytes. `get_backend`
chooses between them as ``ntlink_tpu.sketch.get_backend`` does: the hybrid
for backend=hybrid, and for backend=auto whenever the C sketcher is built
and the run has more than one host thread.
"""
from __future__ import annotations

import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np

from . import device as device_mod
from . import step_graph
from .hybrid_map import HybridStream
from .mapping_step import sketch_step
from .native import fastx_module, sketch_module
from .ops import nthash_np, sketch_cuda
from .ops.nthash_np import Minimizers
from .seqio import stream_fastx
from .stream_pipeline import BatchStream
from .tracing import GLOBAL as tracer


def get_backend(name: str = "auto", threads: int = 1, device=None):
    """The contig sketcher of backend `name` ("numpy", "jax", "hybrid",
    "auto") on `device` (``ntlink_tpu/sketch.py::get_backend``, :20-50):
    None (the host) for numpy; TorchHybridSketcher for hybrid, and for auto
    with threads > 1 when the C sketcher is built; else TorchSketcher, the
    card alone. hybrid without the C sketcher raises. Unlike the JAX
    package's, auto never gives the device up for the host."""
    if name == "numpy":
        return None
    if name == "hybrid" or (name == "auto" and threads > 1
                            and sketch_module() is not None):
        return TorchHybridSketcher(device, threads=max(1, threads))
    return TorchSketcher(device)


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
    """Adapt a device sketch backend to the HybridStream path interface;
    `bases` counts what it sketched."""

    def __init__(self, backend, k: int, w: int):
        self.backend, self.k, self.w = backend, k, w
        self.bases = 0

    def map_stream_raw(self, named_codes):
        for item in self.backend.sketch_stream(named_codes, self.k, self.w):
            self.bases += item[1]
            yield item


class _HostSketchPath:
    """Threaded native-C sketch path (HybridStream interface); `bases`
    counts what it sketched."""

    def __init__(self, k: int, w: int, threads: int):
        self.k, self.w, self.threads = k, w, threads
        self.bases = 0

    def map_stream_raw(self, named_codes):
        def to_seq(codes):
            if isinstance(codes, np.ndarray):
                return codes
            return nthash_np.encode(codes)

        for item in sketch_sequences(
            ((name, to_seq(c)) for name, c in named_codes),
            self.k,
            self.w,
            threads=self.threads,
        ):
            self.bases += item[1]
            yield item



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

    def __init__(self, device=None, batch_bases: int = 16_000_000):
        self.device = device_mod.resolve(device)
        self.batch_bases = batch_bases
        #: rows sketched exactly on the host (sub-k, oversized with N, or
        #: minimizer-slot overflow)
        self.host_fallbacks = 0
        #: device rows (whole sequences and chunks) and chunked sequences
        self.device_rows = 0
        self.chunked = 0
        #: device batches whose step was issued, by (padded row length,
        #: has N): one sketch kernel launch each
        self.batches_by_pad: Dict[Tuple[int, bool], int] = {}
        #: sketch kernel launches of every stream so far
        self.kernel_launches = 0
        #: wall seconds of every stream so far
        self.stream_seconds = 0.0
        #: the graphs of its steps (``step_graph.StepGraphs``), None where
        #: the step runs eagerly; a test may put a stand-in here
        self.graphs = step_graph.for_device(self.device)

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
        graphs0 = step_graph.counts([self.graphs])
        fallbacks0 = self.host_fallbacks
        t0 = time.perf_counter()
        batches = _ContigBatches(self, k, w)
        try:
            yield from batches.run(named_seqs)
        finally:
            secs = time.perf_counter() - t0
            self.stream_seconds += secs
            self.kernel_launches += sketch_cuda.launches - launches0
            graphs = step_graph.summary(step_graph.counts([self.graphs]),
                                        graphs0)
            print(
                f"# ntlink_tpu_torch sketch ({self.device}): {batches.seqs} "
                f"sequence(s) in {secs:.3f} s; "
                f"{sketch_cuda.launches - launches0} sketch kernel "
                f"launch(es); so far {self.device_rows} device row(s), "
                f"{self.chunked} chunked sequence(s), batches by (pad, has "
                f"N) {self.batches_by_pad}; "
                f"{self.host_fallbacks - fallbacks0} row(s) of this stream "
                f"on the exact host path (sub-k, oversized with N, or "
                f"slot overflow); {graphs}",
                file=sys.stderr,
            )


class _ContigBatches(BatchStream):
    """One contig sketch stream of a `TorchSketcher`. An item is a
    sequence; a device row is a whole sequence or a chunk of one, tagged
    (item, its chunks' results, chunk, offset). The drainer puts a
    sequence's chunks' results in place, and the sequence in `results`
    once they are all there."""

    def __init__(self, sketcher: TorchSketcher, k: int, w: int):
        super().__init__(sketcher, 2, "ntlink-torch-sketch")
        self.sketcher, self.k, self.w = sketcher, k, w
        #: sequences taken in
        self.seqs = 0

    def run(self, named_seqs):
        sk, k, w = self.sketcher, self.k, self.w
        try:
            for name, seq in named_seqs:
                self.seqs += 1
                i = len(self.names)
                self.names.append(name)
                self.lengths.append(len(seq))
                codes = (
                    seq if isinstance(seq, np.ndarray)
                    else nthash_np.encode(seq)
                )
                has_n = bool((codes > 3).any())
                if len(codes) < k or (len(codes) > self.max_pad and has_n):
                    # chunk seams do not compose with the windows over
                    # valid k-mers, so oversized N rows stay on the host
                    self.results[i] = [sk._host_sketch(codes, k, w)]
                elif len(codes) > self.max_pad:
                    S = self.max_pad - (k + w - 2)
                    M = len(codes) - (k + w - 2)  # windows in all
                    parts = [None] * ((M + S - 1) // S)
                    sk.chunked += 1
                    for ci in range(len(parts)):
                        lo = ci * S
                        hi = min(lo + S, M) + (k + w - 2)
                        self.enqueue((i, parts, ci, lo), codes[lo:hi], False)
                else:
                    self.enqueue((i, [None], 0, 0), codes, has_n)
                yield from self.ready()
                if self.budget >= self.limit:
                    yield from self.flush_all()
            yield from self.flush_all()
        finally:
            self.pipe.close()

    def enqueue(self, tag: tuple, codes: np.ndarray, has_n: bool) -> None:
        """Bucket one device row."""
        log_pad = int(self.pad_log2(len(codes)))
        self.add(2 * log_pad + has_n, [tag], [codes])
        self.budget += 1 << log_pad

    def step(self, key, packed, nmask, lengths, n_rows: int):
        sk, pad = self.sketcher, key[0]
        slots = sk._slots_for(pad, self.w)
        p, ln, nm = self.upload(sk.device, packed, lengths, nmask,
                                copy=sk.graphs is None)
        if sk.graphs is None:
            out = sketch_step(p, ln, self.k, self.w, pad, slots, nmask=nm)
        else:
            # the graph set copies the host tensors into its inputs
            out = sk.graphs.run(
                sketch_step, dict(packed=p, lengths=ln, nmask=nm),
                dict(k=self.k, w=self.w, L=pad, max_mins=slots))
        # counted once the step is issued: a batch whose step raised
        # launched no kernel
        sk.batches_by_pad[key] = sk.batches_by_pad.get(key, 0) + 1
        return slots, [(*self.download(out), 0, len(lengths))]

    def decode(self, flat, slots, lo, hi, tags, rows) -> None:
        B = hi - lo
        count, n_mins = flat[:B], flat[B : 2 * B]
        planes = flat[2 * B :].reshape(3, B * slots)
        offs = np.zeros(B + 1, np.int64)
        np.cumsum(count, out=offs[1:])
        for row, (i, parts, ci, base_off) in enumerate(tags):
            n = int(count[row])
            if n_mins[row] > slots:
                parts[ci] = _Resketch(rows[row], base_off)
            else:
                self.sketcher.device_rows += 1
                o = int(offs[row])
                ps = planes[0, o : o + n]
                hashes = (
                    planes[1, o : o + n].view(np.uint32).astype(np.uint64)
                    << np.uint64(32)
                ) | planes[2, o : o + n].view(np.uint32).astype(np.uint64)
                parts[ci] = Minimizers(
                    hashes, (ps & 0x3FFFFFFF).astype(np.int64) + base_off,
                    (ps >> 30).astype(bool),
                )
            if None not in parts:
                self.results[i] = parts

    def take(self, parts) -> Minimizers:
        """A sequence's sketch from its chunks' (each sketched on the host
        where it overflowed its slots). The whole-sequence sketch emits at
        window j iff winner(j) != winner(j-1); a chunk's first window
        always emits, so drop it iff it equals the previous chunk's
        last-window winner, which is that chunk's last emitted minimizer
        before its own trim."""
        hs, ps, fs = [], [], []
        prev_last = -1
        for m in parts:
            if isinstance(m, _Resketch):
                h = self.sketcher._host_sketch(m.codes, self.k, self.w)
                m = Minimizers(h.hashes, h.positions + m.base_off, h.forward)
            if len(parts) == 1:
                return m
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


#: the hybrid sketcher's assignment quanta: a block is ~one device bucket
#: of bases; the item quantum keeps streams of many small sequences
#: splitting (``HybridSketcher``'s `block_items` and `block_bases`)
HYBRID_BLOCK_ITEMS = 64
HYBRID_BLOCK_BASES = 16_000_000


def _card_counter(name: str) -> property:
    return property(lambda self: getattr(self.device_backend, name),
                    doc=f"The card path's `TorchSketcher.{name}`.")


class TorchHybridSketcher:
    """`sketch_stream` backend that splits the sequences between a
    TorchSketcher and the native C thread pool (``HybridSketcher``'s
    contract and quanta). The card path's counters read through, so that a
    reader of `pipeline.last_sketcher` needs no case for the hybrid; its
    `host_fallbacks` are the card path's exact host rows, not the C path's
    sequences (`host_seqs`)."""

    batches_by_pad = _card_counter("batches_by_pad")
    kernel_launches = _card_counter("kernel_launches")
    device_rows = _card_counter("device_rows")
    chunked = _card_counter("chunked")
    host_fallbacks = _card_counter("host_fallbacks")

    def __init__(self, device=None, threads: int = 4,
                 host_frac: float = -1.0):
        if sketch_module() is None:
            # the host path is the C thread pool, never the NumPy hasher
            raise RuntimeError(
                "backend=hybrid requires the native C sketch module "
                "(ntlink_tpu_torch.native.sketch) — build it or use "
                "backend=jax/auto"
            )
        self.device_backend = TorchSketcher(device)
        self.threads = max(1, threads)
        self.host_frac = host_frac
        #: sequences each path delivered in the latest stream, and the
        #: bases each sketched (a sequence that a stall rescue ran again on
        #: the other path counts on both)
        self.host_seqs = 0
        self.device_seqs = 0
        self.host_bases = 0
        self.device_bases = 0
        #: wall seconds of every stream so far (the card path's own, of its
        #: share alone, are `device_backend.stream_seconds`)
        self.stream_seconds = 0.0

    def sketch_stream(self, named_seqs, k: int, w: int):
        card = _DeviceSketchPath(self.device_backend, k, w)
        host = _HostSketchPath(k, w, self.threads)
        sched = HybridStream(card, host, host_frac=self.host_frac)
        sched.BLOCK_READS = HYBRID_BLOCK_ITEMS
        sched.BLOCK_BASES = HYBRID_BLOCK_BASES
        t0 = time.perf_counter()
        try:
            yield from sched.stream(named_seqs)
        finally:
            secs = time.perf_counter() - t0
            self.stream_seconds += secs
            self.host_seqs = sched.host_reads
            self.device_seqs = sched.device_reads
            self.host_bases, self.device_bases = host.bases, card.bases
            _trace_paths(sched)
            print(
                f"# ntlink_tpu_torch hybrid sketch: {secs:.3f} s; "
                f"{self.device_seqs} sequence(s), {card.bases} bases on "
                f"{self.device_backend.device}; {self.host_seqs}, "
                f"{host.bases} bases on the host's {self.threads} C "
                f"thread(s)",
                file=sys.stderr,
            )


def _trace_paths(sched: HybridStream) -> None:
    """The spans (v=1) of a hybrid contig sketch's two paths, from
    `sched.path_times`: contig-sketch/card and contig-sketch/host, each from
    the path's first block to its last result, and contig-sketch/tail, from
    the first path's last result to the second's (a path that got no block
    ends where the stream began)."""
    times = sched.path_times
    if not tracer.enabled or times is None:
        return
    start, paths = times
    now_ns, now = time.time_ns(), time.monotonic()

    def ns(t: float) -> int:
        return now_ns - int((now - t) * 1e9)

    ends = []
    for path, span in (("device", "card"), ("host", "host")):
        first, last = paths[path]
        if last is not None:
            tracer.add(f"contig-sketch/{span}", ns(first), last - first)
        ends.append(start if last is None else last)
    if any(last is not None for _, last in paths.values()):
        tracer.add("contig-sketch/tail", ns(min(ends)),
                   max(ends) - min(ends))


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
    (binary file handle). Traced (v=1) as the span contig-sketch/render:
    the seconds of every sequence's rendering and write, summed, from the
    first one's start."""
    timed = tracer.enabled
    first_ns, render_s = None, 0.0
    for name, seq_len, mins in sketch_sequences(
        named_seqs, k, w, backend=backend, threads=threads
    ):
        if timed:
            t0 = time.perf_counter()
            if first_ns is None:
                first_ns = time.time_ns()
        body = format_minimizers_bytes(mins, with_strand=with_strand)
        if with_len:
            out_fh.write(f"{name}\t{seq_len}\t".encode() + body + b"\n")
        else:
            out_fh.write(f"{name}\t".encode() + body + b"\n")
        if timed:
            render_s += time.perf_counter() - t0
    if first_ns is not None:
        tracer.add("contig-sketch/render", first_ns, render_s)


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
