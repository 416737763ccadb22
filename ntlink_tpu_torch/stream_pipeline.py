"""The batched, in-order device stream under both hot loops.

Counterpart of ``ntlink_tpu/stream_pipeline.py`` without its
capped-transfer protocol (the port copies each batch's whole payload back).
`BatchStream` is the one stream under the read mapper
(``device_map.TorchMapper.map_stream_raw``) and the contig sketcher
(``sketch.TorchSketcher.sketch_stream``): (pad, has N) buckets, full and
partial batch heights, packing, the upload, the copy back, the budget
flush and in-order delivery. Each client subclasses it with its intake,
its step and its payload's decoding. The work is split over three
threads (`DevicePipeline`):

  producer (caller's thread): read / encode / pack / consume results
  feeder:   every device call: H2D copies, step dispatch, async D2H starts
  drainer:  the blocking waits on the device->host copies

FIFO queues (bounded depth -> backpressure) preserve batch order end to
end. Worker exceptions are captured and re-raised on the producer thread
at the next `join_all()`. Shutdown is bounded: a wedged worker (stuck
device call on a dead link) cannot hang the producer's generator-close
path — the sentinel put and the thread joins all time out, leaking only
daemon threads the process does not wait on.

``NTLINK_TIMING=1`` splits a read stream's wall by thread and key
(`PhaseTimer`, `PhaseTimer.THREADS`; `TorchMapper.last_timing`):

  producer: reader_pull, read_prep, host_remap, pack, feed_enqueue_wait,
            flush_join (TorchMapper.map_stream_raw); group_gather,
            chain_render, verbose_write, tally (the consumer in
            pipeline.map_reads)
  feeder:   h2d_put, dispatch, copy_back, drain_enqueue_wait
  drainer:  drain_flat_wait, drain_decode
  reader:   reader_parse (seqio.fastx.prefetch_files' parser thread)

The reads cross from the reader to the stream in blocks
(``seqio.fastx.CodeBlock``), so reader_parse and reader_pull open once per
block; read_prep is the stream's own time: its intake of each block and
its delivery of each read.

group_gather, chain_render, verbose_write and the native consumer's tally
open once per read group, each in a ``ntlink/<key>`` `record_function`
range while a torch profiler records. The thread's CPU seconds
(``time.thread_time``; `TorchMapper.last_cpu` and `last_thread_cpu`, the
``# ntlink cpu:`` line) tell work apart from waits: on a queue, a device,
or the interpreter lock while another thread runs Python. The keys timed
at most once per batch, flush, remap or group carry their CPU beside their
wall. The keys timed per block or per read (reader_pull, read_prep,
reader_parse, the runs-only consumer's tally) carry none: a thread CPU
clock can be a system call (2.7 us a read of it, in 10 ms steps, on an
H100 host), and reading it twice a read slows the stream it splits; the
producer's and the reader's whole CPU in the stream stand in for them.
h2d_put and drain_flat_wait, timed with the wire's byte counts, carry
none either.
"""
from __future__ import annotations

import contextlib
import os
from collections import Counter
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import tracing
from .mapping_step import pack_codes
from .native import fastx_module


class DevicePipeline:
    """Feeder/drainer thread pair around caller-supplied batch handlers.

    `dispatch(*ent)` runs on the feeder thread; it should end by calling
    `submit_drain(ent2)` to forward the in-flight batch. `drain(*ent2)`
    runs on the drainer thread.
    """

    def __init__(
        self,
        dispatch: Callable[..., None],
        drain: Callable[..., None],
        depth: int = 2,
        name: str = "ntlink",
    ) -> None:
        self._dispatch = dispatch
        self._drain = drain
        self._feed_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._work_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.errors: List[BaseException] = []
        self._threads: List[threading.Thread] = []
        self._name = name

    # -- worker loops -----------------------------------------------------

    def _run_loop(self, q: "queue.Queue", fn) -> None:
        while True:
            ent = q.get()
            try:
                if ent is not None and not self.errors:
                    fn(*ent)
            except BaseException as exc:  # surfaced at next join_all()
                self.errors.append(exc)
            finally:
                q.task_done()
            if ent is None:
                return

    def _ensure_started(self) -> None:
        if self._threads:
            return
        for q, fn, suffix in (
            (self._work_q, self._drain, "drain"),
            (self._feed_q, self._dispatch, "feed"),
        ):
            t = threading.Thread(
                target=self._run_loop,
                args=(q, fn),
                daemon=True,
                name=f"{self._name}-{suffix}",
            )
            t.start()
            self._threads.append(t)

    # -- producer API -----------------------------------------------------

    def submit(self, ent: tuple) -> None:
        """Producer -> feeder (blocks on backpressure at queue depth)."""
        self._ensure_started()
        self._feed_q.put(ent)

    def submit_drain(self, ent: tuple) -> None:
        """Feeder -> drainer (called from inside `dispatch`)."""
        self._work_q.put(ent)

    def join_all(self) -> None:
        """Wait for every submitted batch to drain; re-raise worker errors."""
        self._feed_q.join()
        self._work_q.join()
        if self.errors:
            raise self.errors[0]

    def close(self, timeout: float = 60.0) -> None:
        """Bounded shutdown (see module docstring)."""
        if not self._threads:
            return
        for q in (self._feed_q, self._work_q):
            try:
                q.put(None, timeout=timeout)
            except queue.Full:
                pass
        for t in self._threads:
            t.join(timeout=timeout)


class PhaseTimer:
    """Per-phase wall-clock accounting of a read stream (``NTLINK_TIMING=1``
    in ``ntlink_tpu/device_map.py``): seconds and number of spans per key.
    Each key is written by one thread only, so the seconds of one thread's
    keys cannot sum past the stream's wall. When `on` is False nothing is
    recorded and `now` reads no clock.

    A key that opens at most once per group or batch may be timed with
    `span`, which also opens a `record_function` range ``ntlink/<key>``
    while a torch profiler records (``tracing.open_range``); per-read keys
    open none."""

    #: the read stream's keys, by the thread that each is timed on. The
    #: producer is the thread that iterates the stream (the main thread):
    #: `TorchMapper.map_stream_raw`'s own keys (`reader_pull` is one per
    #: block; `read_prep` is its time outside the other keys there: each
    #: block's intake, bucketing and bookkeeping, and each read's
    #: delivery), then those of the consumer in ``pipeline`` (`tally` in
    #: both consumers, the others in the native one). The reader is the
    #: thread that parses the stream's file
    #: (``seqio.fastx.prefetch_files``; `reader_parse` is one per block);
    #: it may start before the stream, by the blocks its queue holds.
    THREADS = {
        "producer": ("reader_pull", "read_prep", "host_remap", "pack",
                     "feed_enqueue_wait", "flush_join", "group_gather",
                     "chain_render", "verbose_write", "tally"),
        "feeder": ("h2d_put", "dispatch", "copy_back",
                   "drain_enqueue_wait"),
        "drainer": ("drain_flat_wait", "drain_decode"),
        "reader": ("reader_parse",),
    }

    def __init__(self, on: bool):
        self.on = on
        #: key -> (seconds, spans)
        self.acc: Dict[str, Tuple[float, int]] = {}
        #: key -> CPU seconds of its thread inside its spans, for the keys
        #: timed by `now`/`mark` and `span`
        self.cpu: Dict[str, float] = {}
        #: thread of `THREADS` -> its whole CPU seconds in the stream, for
        #: the threads that read it (`thread_cpu_since`)
        self.thread_cpu: Dict[str, float] = {}
        #: each thread's CPU clock at its last `now` or `mark`
        self._cpu0 = threading.local()

    @classmethod
    def from_env(cls) -> "PhaseTimer":
        """On when NTLINK_TIMING is set, read now."""
        return cls(bool(os.environ.get("NTLINK_TIMING")))

    def now(self) -> float:
        """The start of a span that `mark` closes on this thread."""
        if not self.on:
            return 0.0
        self._cpu0.t = time.thread_time()
        return time.perf_counter()

    def add(self, key: str, seconds: float, spans: int = 1,
            cpu: Optional[float] = None) -> None:
        """`spans` spans of `seconds` in all under `key`, and `cpu` CPU
        seconds of their thread in them if given."""
        if self.on:
            s, n = self.acc.get(key, (0.0, 0))
            self.acc[key] = (s + seconds, n + spans)
            if cpu is not None:
                self.cpu[key] = self.cpu.get(key, 0.0) + cpu

    def mark(self, key: str, t0: float) -> float:
        """Close the span begun at `t0` (this thread's last `now` or
        `mark`) under `key`; returns the start of the next one."""
        if not self.on:
            return 0.0
        t1 = time.perf_counter()
        c1 = time.thread_time()
        self.add(key, t1 - t0, cpu=c1 - self._cpu0.t)
        self._cpu0.t = c1
        return t1

    def cpu_now(self) -> float:
        """This thread's CPU clock, for `thread_cpu_since` (0 when off)."""
        return time.thread_time() if self.on else 0.0

    def thread_cpu_since(self, thread: str, c0: float) -> None:
        """This thread's CPU seconds since `cpu_now` gave `c0`, under
        `thread`."""
        if self.on:
            self.thread_cpu[thread] = (self.thread_cpu.get(thread, 0.0)
                                       + time.thread_time() - c0)

    def span(self, key: str):
        """A `with` block timed as one span under `key`, inside a
        ``ntlink/<key>`` range while a torch profiler records; a shared
        no-op context when off."""
        return _Span(self, key) if self.on else _OFF

    def timed(self, it, key: str):
        """`it`, with every `next` on it timed under `key`."""
        it = iter(it)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.add(key, time.perf_counter() - t0)
            yield item

    def self_timed(self, gen, key: str, inner: Tuple[str, ...]):
        """`gen`, with the time that each `next` spends inside it, less that
        of the keys in `inner` that it times on this thread meanwhile,
        under `key`: one span per item. Closing this generator closes
        `gen`."""
        before = sum(self.acc.get(k, (0.0, 0))[0] for k in inner)
        own, items = 0.0, 0
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    own += time.perf_counter() - t0
                    return
                own += time.perf_counter() - t0
                items += 1
                yield item
        finally:
            gen.close()
            after = sum(self.acc.get(k, (0.0, 0))[0] for k in inner)
            self.add(key, own - (after - before), items)

    def line(self) -> str:
        """``# ntlink timing: key=1.234s/56 ...``, keys sorted."""
        return "# ntlink timing: " + " ".join(
            f"{k}={self.acc[k][0]:.3f}s/{self.acc[k][1]}"
            for k in sorted(self.acc)
        )

    def cpu_line(self) -> str:
        """``# ntlink cpu: key=0.987s ... threads producer=12.345s ...``:
        the CPU seconds of the keys that carry them, then of the threads,
        each sorted."""
        return "# ntlink cpu: " + " ".join(
            [f"{k}={self.cpu[k]:.3f}s" for k in sorted(self.cpu)]
            + ["threads"]
            + [f"{t}={self.thread_cpu[t]:.3f}s"
               for t in sorted(self.thread_cpu)])


class _Span:
    """One `PhaseTimer.span`."""

    __slots__ = ("timer", "key", "t0", "c0", "rf")

    def __init__(self, timer: PhaseTimer, key: str):
        self.timer, self.key = timer, key

    def __enter__(self):
        self.rf = tracing.open_range(self.key)
        self.c0 = time.thread_time()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.timer.add(self.key, time.perf_counter() - self.t0,
                       cpu=time.thread_time() - self.c0)
        tracing.close_range(self.rf)
        return False


_OFF = contextlib.nullcontext()


def next_pow2(n: int) -> int:
    """Next power of two >= n (>=1): batch heights and slot budgets come
    in a handful of reusable shapes."""
    n = max(1, n)
    p = 1
    while p < n:
        p <<= 1
    return p


def split_n_rows(row_codes: List[np.ndarray], B: int, pad: int):
    """For a batch of N-containing rows: return (clean_rows, packed_nmask).

    2-bit packing cannot carry N — clean the non-ACGT codes to 0 and build
    the (B, pad//8) little-bit-order non-ACGT mask that re-materializes
    them on device (2.25 bits/base wire total).
    """
    bad = np.zeros((B, pad), dtype=bool)
    clean = []
    for row, c in enumerate(row_codes):
        b = c > 3
        bad[row, : len(c)] = b
        clean.append(np.where(b, 0, c).astype(np.uint8))
    return clean, np.packbits(bad, axis=1, bitorder="little")


def batch_rows(pad: int, batch_bases: int) -> int:
    """Rows of a full device batch at padded length `pad`: the power of two
    nearest above batch_bases / pad (``DeviceMapper``'s batch height)."""
    return next_pow2(max(1, batch_bases // pad))


class BatchStream:
    """One stream of rows through a device step, in batches, its items
    delivered in input order. A client subclasses it with

    - its intake: a generator that takes items in (`names`, `lengths`),
      puts their device rows in buckets (`add`) and the rest's results in
      `results`, and yields `ready` as it goes and `flush_all` once
      `budget` reaches `limit`, and at its end;
    - `step(key, packed, nmask, lengths, n_rows)`, on the feeder: every
      device call of a batch of `key` (pad, has N), whose first `n_rows`
      rows are rows and the rest padding, returning (slots, [(host
      tensor, event, lo, hi)]): each block of rows lo..hi-1 with its
      payload's copy back (`upload`, `download`);
    - `decode(flat, slots, lo, hi, tags, rows)`, on the drainer: a block's
      payload `flat` into `results` (`tags` and `rows` are the batch's
      rows' tags and codes);
    - `take(result)`, on the producer: an item's result as delivered.

    A device row joins the bucket of its (pad, has N), coded 2 log2(pad)
    + has N, which flushes as a batch once it holds `batch_rows` rows; a
    partial flush steps the height down to the next power of two. Every
    `FLUSH_BATCHES` batches' worth of padded bases (`limit`) every bucket
    flushes and every item so far is delivered (`flush_all`). An item's
    index counts from the last `flush_all`, and its result sits under that
    index in `results` until it is delivered as (name, length,
    take(result)).

    `timer` keys the producer's pack, feed_enqueue_wait and flush_join,
    the feeder's h2d_put, copy_back and drain_enqueue_wait, and the
    drainer's drain_flat_wait and drain_decode (off by default); `wire`
    counts the bytes each way and the seconds spent on them
    (``TorchMapper.wire_stats``)."""

    #: batches' worth of padded device rows between two flushes of every
    #: bucket (`flush_all`)
    FLUSH_BATCHES = 4

    def __init__(self, owner, depth: int, name: str,
                 timer: Optional[PhaseTimer] = None, wire=None):
        """Pads and batch bases from `owner` (`MIN_PAD`, `MAX_PAD`,
        `batch_bases`), read now."""
        self.min_pad, self.max_pad = owner.MIN_PAD, owner.MAX_PAD
        self.batch_bases = owner.batch_bases
        self.limit = self.FLUSH_BATCHES * owner.batch_bases
        self.timer = PhaseTimer(False) if timer is None else timer
        self.wire = Counter() if wire is None else wire
        self.names: List[str] = []
        self.lengths: List[int] = []
        self.results: Dict[int, object] = {}
        #: the next item to deliver
        self.next_yield = 0
        #: bucket code -> (row tags, row codes), in the order of each
        #: bucket's first row since the last flush_all
        self.buckets: Dict[int, Tuple[list, list]] = {}
        #: padded bases of the device rows since the last flush_all
        self.budget = 0
        self.pipe = DevicePipeline(self._dispatch, self._drain, depth=depth,
                                   name=name)

    # -- rows and buckets (producer) ----------------------------------------

    def pad_log2(self, lengths):
        """log2 of the padded length of rows of `lengths` bases: the next
        power of two, held between MIN_PAD and MAX_PAD (``frexp`` of n - 1
        is its bit length, exact below 2**53)."""
        bits = np.frexp(np.maximum(lengths, 1) - 1)[1]
        return np.clip(bits, self.min_pad.bit_length() - 1,
                       self.max_pad.bit_length() - 1).astype(np.int64)

    def full_height(self, code: int) -> int:
        return batch_rows(1 << (code >> 1), self.batch_bases)

    def room(self, code: int) -> int:
        """Rows that bucket `code` takes before it flushes."""
        bucket = self.buckets.get(code)
        return self.full_height(code) - (0 if bucket is None
                                         else len(bucket[0]))

    def add(self, code: int, tags: list, rows: list) -> bool:
        """Put device rows (`rows`: codes, `tags`: the client's handle on
        each) in bucket `code`, flushing it if it fills; whether it did."""
        bucket = self.buckets.get(code)
        if bucket is None:
            bucket = self.buckets[code] = ([], [])
        bucket[0].extend(tags)
        bucket[1].extend(rows)
        if len(bucket[0]) < self.full_height(code):
            return False
        self.flush_bucket(code)
        return True

    def flush_bucket(self, code: int) -> None:
        tags, rows = self.buckets[code]
        self.buckets[code] = ([], [])
        key = pad, has_n = 1 << (code >> 1), bool(code & 1)
        B = min(self.full_height(code), next_pow2(len(tags)))
        lengths = np.zeros(B, dtype=np.int32)
        lengths[: len(rows)] = [len(c) for c in rows]
        timer = self.timer
        ts = timer.now()
        packed, nmask = pack_batch(rows, B, pad, has_n)
        ts = timer.mark("pack", ts)
        self.pipe.submit((key, packed, nmask, lengths, tags, rows))
        timer.mark("feed_enqueue_wait", ts)

    # -- delivery (producer) ------------------------------------------------

    def ready(self):
        """The items whose results are in, in input order, up to the first
        that is not (the drainer only adds results; this thread pops)."""
        names, lengths, results = self.names, self.lengths, self.results
        take = self.take
        i = self.next_yield
        while i < len(names) and i in results:
            yield names[i], lengths[i], take(results.pop(i))
            i += 1
        self.next_yield = i

    def flush_all(self):
        """Flush every bucket, wait for every batch, and deliver every item
        so far."""
        for code, (tags, _) in list(self.buckets.items()):
            if tags:
                self.flush_bucket(code)
        self.buckets.clear()
        ts = self.timer.now()
        self.pipe.join_all()
        self.timer.mark("flush_join", ts)
        names, lengths, results = self.names, self.lengths, self.results
        for i in range(self.next_yield, len(names)):
            yield names[i], lengths[i], self.take(results.pop(i))
        names.clear()
        lengths.clear()
        self.next_yield = self.budget = 0

    # -- device calls (feeder and drainer) ----------------------------------

    def upload(self, device: torch.device, packed: np.ndarray,
               lengths: np.ndarray, nmask, copy: bool, rows=None):
        """Feeder: (packed, lengths, nmask or None) as host tensors, in
        pinned memory on a CUDA device, then with `copy` on `device` by an
        asynchronous upload on the current stream (without, a graph set or
        a sharded step copies them in itself). The devices get `rows` of
        its rows in all (default: each once), for `wire`."""
        tw = time.perf_counter()
        out = pinned(device, packed, lengths, nmask)
        if copy and device.type == "cuda":
            out = tuple(None if t is None else t.to(device, non_blocking=True)
                        for t in out)
        dt = time.perf_counter() - tw
        self.timer.add("h2d_put", dt)
        nbytes = (packed.nbytes + lengths.nbytes
                  + (0 if nmask is None else nmask.nbytes))
        self.wire["h2d"] += (nbytes if rows is None
                             else nbytes * rows // len(lengths))
        self.wire["h2d_s"] += dt
        return out

    def download(self, out: torch.Tensor):
        """Feeder: `copy_back` of a step's payload."""
        ts = self.timer.now()
        host = copy_back(out)
        self.timer.mark("copy_back", ts)
        return host

    def _dispatch(self, key, packed, nmask, lengths, tags, rows) -> None:
        slots, blocks = self.step(key, packed, nmask, lengths, len(tags))
        ts = self.timer.now()
        self.pipe.submit_drain((slots, blocks, tags, rows))
        self.timer.mark("drain_enqueue_wait", ts)

    def _drain(self, slots, blocks, tags, rows) -> None:
        # the blocks in row order: each item's result lands under its own
        # index, so the items of other batches keep their place
        timer, wire = self.timer, self.wire
        for host, event, lo, hi in blocks:
            tw = time.perf_counter()
            if event is not None:
                event.synchronize()
            flat = host.numpy()
            dt = time.perf_counter() - tw
            wire["d2h"] += flat.nbytes
            wire["d2h_s"] += dt
            timer.add("drain_flat_wait", dt)
            ts = timer.now()
            self.decode(flat, slots, lo, hi, tags, rows)
            timer.mark("drain_decode", ts)


_TORCH_DTYPES = {np.uint8: torch.uint8, np.int32: torch.int32}


def pinned(device: torch.device, *arrays):
    """Host tensors of `arrays` (None stays None), in pinned memory when
    `device` is a CUDA device, so that several devices can each start an
    asynchronous upload of their share."""
    on_cuda = device.type == "cuda"
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        t = torch.empty(a.shape, dtype=_TORCH_DTYPES[a.dtype.type],
                        pin_memory=on_cuda)
        t.numpy()[...] = a
        out.append(t)
    return tuple(out)


def copy_back(out: torch.Tensor):
    """Start the copy of a step's payload to the host: (host tensor, CUDA
    event marking the copy's end, or None on the CPU). The drainer waits
    on the event before it reads the host tensor. A graph's payload is its
    static output, which the next replay overwrites, so on the CPU too the
    payload is copied."""
    if out.device.type != "cuda":
        return out.clone(), None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def pack_batch(row_codes: List[np.ndarray], B: int, pad: int, has_n: bool):
    """Host side of a device batch: (packed (B, pad/4) uint8 2-bit codes,
    nmask (B, pad/8) bit-packed non-ACGT mask or None). Rows of a has_n
    batch are cleaned to A for packing (``split_n_rows``)."""
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
