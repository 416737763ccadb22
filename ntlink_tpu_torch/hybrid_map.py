"""Hybrid CPU+device mapping: drive the device and the host C path together.

When the device leg is transfer-bound (bench.py `wire_bound_fraction` near
1.0 — the normal state behind a slow host<->device link, and common even on
healthy hosts once the kernel saturates the wire), the host cores sit idle
while the chip waits on transfers. `HybridMapper` splits the read stream
between a `TorchMapper` and a `HostMapper` (native/sketch.c + C chaining),
runs both concurrently, and re-emits results strictly in input order — so
every downstream artifact (verbose TSV, PAF, tally order) is byte-identical
to either path alone: both paths produce identical raw anchor payloads
(tests/test_native_sketch.py payload parity), and the assignment policy can
therefore never change outputs, only speed.

Design (deadlock-free by construction):

- each path gets ONE persistent `map_stream_raw` stream for the whole run
  (the device's internal 3-thread batching pipeline stays warm), fed from
  an unbounded per-path queue via a blocking generator that ends when the
  hybrid stream ends,
- both mappers deliver strictly in their own input order, so a per-path
  FIFO of sequence numbers matches outputs positionally,
- results land in a seq-indexed reorder buffer; the main thread yields the
  contiguous prefix as it forms (and blocks only at end-of-input, when
  both runners are guaranteed to terminate: their input generators end,
  the mappers flush),
- scheduling is pull-based: ready blocks queue in a small central pool,
  and each path pulls another block only while its projected backlog
  (pending_bases / measured service rate) is under DEPTH_S seconds.
  Time-based depth keeps both paths saturated mid-stream AND bounds the
  makespan tail: near end-of-input the pool drains to whichever path
  frees capacity first, so the slow path never holds a deep committed
  backlog. Service rate is an EMA measured over busy spans only (idle
  time between assignments never depresses a path's rate), persisted
  across streams on the same scheduler. Any policy is correct; this one
  just balances load.

Select with `backend=hybrid` (cfg/CLI); `hybrid_host_frac` in [0, 1] pins
a static host share instead (tests / manual tuning).
"""
from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Iterable, Iterator, Optional, Tuple

BLOCK_READS = 1024    # assignment quantum: one full device bucket at the
                      # default batch_bases/pad, so device-routed blocks map
                      # as full-height batches instead of idle-flush dribbles
BLOCK_BASES = 16_000_000  # bases cap on a block (ultra-long-read streams)
SKEW_WARN = 100_000   # undelivered-result warning threshold
BUF_CAP = 50_000      # undelivered results: stop feeding beyond this.
#                       Sized down from 200k when the scheduler started
#                       retaining in-flight payloads for stall rescue: a
#                       long device stall can skew the buffer to the cap,
#                       and 200k x 12 kb reads held ~2.4 GB of codes on
#                       top of the result payloads (19 GiB peak RSS seen
#                       at the 3 Gb stress); 50k bounds that at ~600 MB
#                       with no measurable throughput cost (the ready
#                       prefix drains continuously)
MAX_LAG_S = 5.0       # per-path in-flight cap: rate * this many seconds


class _Runner:
    """One mapping path: queue -> persistent mapper stream -> reorder buf."""

    def __init__(self, name: str, mapper, sink, prior_rate: float):
        self.name = name
        self.mapper = mapper
        self.sink = sink
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.queue: deque = deque()     # (seq, name, codes)
        self.fifo: deque = deque()      # seqs in fed order
        self.closed = False
        self.error: Optional[BaseException] = None
        self.pending_bases = 0
        self.pending_items = 0
        self.rate = prior_rate          # bases/s EMA over busy spans
        self._span_start = 0.0
        self._span_bases = 0
        self.reads_done = 0
        #: consecutive rescues with zero deliveries in between — a path
        #: that keeps getting rescued without ever delivering is wedged,
        #: and the re-trigger delay drops so the backlog drains at rescue
        #: bandwidth instead of one trigger per STALL_RESCUE_S
        self.rescues_since_progress = 0
        #: stall clock: last time this path delivered a result OR went
        #: from idle to fed (so warmup stalls are measured from the feed)
        self.last_progress_t = time.monotonic()
        #: monotonic times of its first block and of its last result (None
        #: before either), for `HybridStream.path_times`
        self.first_block_t: Optional[float] = None
        self.last_result_t: Optional[float] = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def submit(self, block) -> None:
        with self.lock:
            if self.pending_bases == 0:
                self._span_start = time.perf_counter()
                self._span_bases = 0
                self.last_progress_t = time.monotonic()
                if self.first_block_t is None:
                    self.first_block_t = self.last_progress_t
            for seq, name, codes in block:
                self.queue.append((seq, name, codes))
                self.fifo.append(seq)
                self.pending_bases += len(codes)
                self.pending_items += 1
            self.cond.notify()

    def close(self) -> None:
        with self.lock:
            self.closed = True
            self.cond.notify()

    def join(self, timeout: float = 30.0) -> None:
        """Bounded join: a path wedged on a dead transport (its daemon
        thread blocked inside the mapper) must not hang the whole stream —
        every result has already been delivered (possibly via rescue) by
        the time join runs, so an over-deadline thread is abandoned with a
        warning instead."""
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            print(
                f"# ntlink hybrid: abandoning wedged {self.name} path "
                f"thread after {timeout:.0f}s (results were delivered "
                f"by the other path)",
                file=sys.stderr,
            )
        if self.error is not None:
            raise self.error

    def idle(self) -> bool:
        with self.lock:
            return self.pending_bases == 0

    def stuck_prefix(self, limit: int, nxt: int = 0):
        """Snapshot of this path's earliest UNDELIVERED (>= nxt) sequence
        numbers, for stall rescue. The filter runs before the window: a
        wedged runner never pops its fifo, so after a few rescues the
        fifo's front is entirely already-delivered entries and a
        window-then-filter order would return [] forever (the fifo itself
        must not be popped — the recovering mapper's 1:1 popleft pairing
        depends on it)."""
        import itertools

        with self.lock:
            return list(
                itertools.islice((s for s in self.fifo if s >= nxt), limit)
            )

    IDLE_FLUSH_S = 0.5
    BLOCKING_POLL_S = 0.02

    def _blocking_delivery(self) -> bool:
        """True when this path's earliest undelivered sequence number is
        the one the whole stream is waiting on (caller must hold lock)."""
        return bool(self.fifo) and self.fifo[0] == self.sink.next

    def _input_gen(self):
        """Ends at close, OR after IDLE_FLUSH_S with an empty queue, OR —
        the fast path — as soon as an empty-queued path is gating global
        delivery (its earliest held sequence number is the stream's next):
        ending the mapper stream forces it to flush partially-filled
        internal batches (TorchMapper buckets, HostMapper windows), so
        sequence numbers held by a momentarily idle path deliver promptly
        instead of stalling the merged order — without this, the hybrid
        stream advances in IDLE_FLUSH_S quanta whenever the device holds a
        part-filled bucket. _run restarts a fresh stream when work arrives
        again."""
        while True:
            deadline = None
            with self.lock:
                while not self.queue and not self.closed:
                    if deadline is None:
                        deadline = time.monotonic() + self.IDLE_FLUSH_S
                    if self._blocking_delivery():
                        return
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                    self.cond.wait(
                        timeout=min(remaining, self.BLOCKING_POLL_S)
                    )
                if not self.queue:
                    return
                _, name, codes = self.queue.popleft()
            yield name, codes

    def _run(self):
        try:
            while True:
                with self.lock:
                    while not self.queue and not self.closed:
                        self.cond.wait()
                    if not self.queue and self.closed:
                        return
                for _, ln, raw in self.mapper.map_stream_raw(
                    self._input_gen()
                ):
                    with self.lock:
                        seq = self.fifo.popleft()
                        self.pending_bases -= ln
                        self.pending_items -= 1
                        self._span_bases += ln
                        self.reads_done += 1
                        self.rescues_since_progress = 0
                        self.last_progress_t = time.monotonic()
                        self.last_result_t = self.last_progress_t
                        dt = time.perf_counter() - self._span_start
                        if dt > 0.05 and self._span_bases > 0:
                            inst = self._span_bases / dt
                            self.rate = 0.7 * self.rate + 0.3 * inst
                    self.sink.post(seq, raw, self.name)
        except BaseException as exc:
            self.error = exc
            self.sink.abort(exc)


class _ReorderSink:
    def __init__(self):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.buf = {}
        self.wins = {}  # path name -> results that won delivery
        self.next = 0
        self.error: Optional[BaseException] = None
        self._warned = False

    def post(self, seq: int, raw, path: str = "") -> None:
        with self.lock:
            if seq < self.next or seq in self.buf:
                return  # duplicate from a stall rescue: first result wins
            self.buf[seq] = raw
            self.wins[path] = self.wins.get(path, 0) + 1
            if len(self.buf) > SKEW_WARN and not self._warned:
                self._warned = True
                print(
                    "# ntlink hybrid: reorder buffer exceeds "
                    f"{SKEW_WARN} results (device stalled?)",
                    file=sys.stderr,
                )
            self.cond.notify()

    def abort(self, exc: BaseException) -> None:
        with self.lock:
            if self.error is None:
                self.error = exc
            self.cond.notify()

    def pop_ready(self):
        """Non-blocking: pop the currently contiguous prefix."""
        out = []
        with self.lock:
            if self.error is not None:
                raise self.error
            while self.next in self.buf:
                out.append(self.buf.pop(self.next))
                self.next += 1
        return out

    def pop_wait(self, timeout: float):
        """Pop the contiguous ready prefix, waiting up to `timeout` for the
        first deliverable result. Returns [] on timeout (caller may run a
        stall rescue and retry)."""
        with self.lock:
            if self.next not in self.buf and self.error is None:
                self.cond.wait(timeout=timeout)
            if self.error is not None:
                raise self.error
            out = []
            while self.next in self.buf:
                out.append(self.buf.pop(self.next))
                self.next += 1
            return out


class HybridStream:
    """Generic two-path ordered stream scheduler.

    Drives two "path" objects — anything exposing
    ``map_stream_raw(iter[(name, payload)]) -> iter[(name, len, result)]``
    with in-order delivery — concurrently over one input stream, re-emitting
    results strictly in input order. Used for mapping (`HybridMapper`:
    TorchMapper + HostMapper) and sketching (`sketch.TorchHybridSketcher`:
    TorchSketcher + native C thread pool). The assignment policy can never
    change outputs (both paths are exact), only speed."""

    #: assignment quantum (overridable per subclass: one device bucket's
    #: worth of items keeps device-routed blocks batching as full heights)
    BLOCK_READS = BLOCK_READS
    BLOCK_BASES = BLOCK_BASES
    #: conservative service-rate priors (bases/s); see stream()
    PRIOR_RATE = 8e6
    #: per-path queued-work target in SECONDS at the learned rate: a path
    #: pulls another block from the central pool only while its projected
    #: backlog is under this. Time-based depth is self-balancing (both
    #: paths finish their queues within ~DEPTH_S of each other, so the
    #: makespan tail is bounded) while still deep enough to keep the
    #: device's internal bucket + feed/drain pipeline (~3 batches ~0.6 s
    #: of work) full mid-stream — 0.4 measured 8.5k reads/s vs 1.0's
    #: 10.0k on the 30k-read bench (device duty 53% -> ~90%).
    DEPTH_S = 1.0
    #: central unassigned backlog (blocks); bounds input read-ahead
    POOL_BLOCKS = 8
    #: minimum in-flight DEPTH (blocks) per path, independent of the
    #: learned rate. The time-based rule alone has a self-reinforcing
    #: fixed point for a high-latency pipelined path (the device behind a
    #: tunnel): with one block in flight its measured rate is the
    #: LATENCY-bound rate, which grants ~one block of depth, which keeps
    #: the rate latency-bound — the path never discovers its pipelined
    #: throughput. A floor of a few blocks keeps the device's internal
    #: feed/drain pipeline primed regardless of the measured rate; the
    #: tail commit it risks is bounded (MIN_DEPTH_BLOCKS blocks) and a
    #: truly wedged path is already covered by the stall rescue.
    MIN_DEPTH_BLOCKS = 3

    def __init__(self, device, host, host_frac: float = -1.0):
        self.device = device
        self.host = host
        self.host_frac = host_frac  # < 0: adaptive
        self._frac_carry = 0.0
        self.host_reads = 0
        self.device_reads = 0
        #: learned service rates (bases/s), persisted across stream()
        #: calls on the same scheduler so a later run starts converged
        self._learned = {}
        #: of the latest stream that ended: (its start, {"device" / "host":
        #: (the path's first block, its last result)}), monotonic seconds,
        #: None for a path that got no block
        self.path_times = None

    def _grant(self, sink, pool, dev, host) -> bool:
        """Pull-based assignment: hand the pool's next block to the
        hungriest path (smallest projected backlog under DEPTH_S). Central
        pool + time-based depth keep both paths saturated mid-stream
        without committing deep tails to the slower path. Returns True if
        a block was granted."""
        if not pool:
            return False
        if self.host_frac >= 0.0:
            # pinned split (tests / manual tuning): fractional accumulator
            # gives exact proportions at any block count
            self._frac_carry += self.host_frac
            if self._frac_carry >= 1.0 - 1e-9:
                self._frac_carry -= 1.0
                host.submit(pool.popleft())
            else:
                dev.submit(pool.popleft())
            return True
        with sink.lock:
            if len(sink.buf) > BUF_CAP:
                return False
        best, best_t = None, None
        floor_items = self.MIN_DEPTH_BLOCKS * self.BLOCK_READS
        for p in (dev, host):
            with p.lock:
                t = p.pending_bases / max(p.rate, 1.0)
                hungry = t < self.DEPTH_S or p.pending_items < floor_items
            if hungry and (best_t is None or t < best_t):
                best, best_t = p, t
        if best is None:
            return False
        best.submit(pool.popleft())
        return True

    def stream(
        self, named_codes: Iterable[Tuple[str, object]]
    ) -> Iterator[Tuple[str, int, Optional[tuple]]]:
        start = time.monotonic()
        sink = _ReorderSink()
        # priors: learned rates from an earlier stream on this scheduler
        # when available (a repeat run starts converged), else conservative
        # equal priors — under-feeding a path during warmup is cheap (the
        # other picks up the slack and the EMA corrects within a block)
        dev = _Runner(
            "device", self.device, sink,
            prior_rate=self._learned.get("device", self.PRIOR_RATE),
        )
        host = _Runner(
            "host", self.host, sink,
            prior_rate=self._learned.get("host", self.PRIOR_RATE),
        )
        dev.start()
        host.start()

        held = {}  # seq -> (name, codes): retained until delivery so a
        #            stalled path's items can re-run on the other path
        seq = 0
        delivered = 0
        block = []
        block_bases = 0
        pool: deque = deque()  # ready blocks not yet assigned to a path

        def deliver(raws):
            nonlocal delivered
            for raw in raws:
                name_o, codes_o = held.pop(delivered)
                delivered += 1
                yield name_o, len(codes_o), raw

        try:
            for name, codes in named_codes:
                held[seq] = (name, codes)
                block.append((seq, name, codes))
                block_bases += len(codes)
                seq += 1
                if (
                    len(block) >= self.BLOCK_READS
                    or block_bases >= self.BLOCK_BASES
                ):
                    pool.append(block)
                    block = []
                    block_bases = 0
                    while self._grant(sink, pool, dev, host):
                        pass
                    yield from deliver(sink.pop_ready())
                    while len(pool) >= self.POOL_BLOCKS:
                        # both paths at depth and the pool full:
                        # backpressure the input
                        yield from deliver(sink.pop_wait(0.02))
                        self._rescue(sink, held, dev, host)
                        while self._grant(sink, pool, dev, host):
                            pass
            if block:
                pool.append(block)
            while pool:
                if not self._grant(sink, pool, dev, host):
                    yield from deliver(sink.pop_wait(0.02))
                    self._rescue(sink, held, dev, host)
            # final drain BEFORE close: the runners' idle-flush input
            # generators force mapper flushes on their own, and keeping the
            # runners feedable lets a stall rescue re-run a wedged path's
            # items on the other path (first result wins at the sink)
            while delivered < seq:
                got = sink.pop_wait(0.25)
                yield from deliver(got)
                if not got:
                    self._rescue(sink, held, dev, host)
            dev.close()
            host.close()
            dev.join(self.JOIN_TIMEOUT_S)
            host.join(self.JOIN_TIMEOUT_S)
            # delivered-result attribution from the sink (a stall rescue
            # can run an item on BOTH paths; only the winner counts)
            self.host_reads = sink.wins.get("host", 0)
            self.device_reads = sink.wins.get("device", 0)
            for p in (dev, host):
                if p.reads_done:
                    self._learned[p.name] = p.rate
        finally:
            dev.close()
            host.close()
            self.path_times = (start, {
                p.name: (p.first_block_t, p.last_result_t)
                for p in (dev, host)})

    #: rescue a path after this long with queued work and zero results
    #: while the other path sits idle (first device batch behind a remote
    #: link can legitimately take ~a minute of server-side compile — the
    #: rescue just re-runs the stranded items on the idle path meanwhile;
    #: pure waste-bounded duplication, never a correctness event)
    STALL_RESCUE_S = 8.0
    #: once a path has been rescued and STILL delivered nothing, it is
    #: known-wedged: re-trigger this fast so the backlog drains at the
    #: healthy path's rate rather than one rescue per STALL_RESCUE_S
    STALL_RETRIGGER_S = 1.0
    #: blocks re-run per rescue trigger (a wedged path can hold
    #: rate * MAX_LAG_S of in-flight work — single-block rescues would
    #: drain that at one block per trigger)
    RESCUE_BLOCKS = 4
    #: minimum undelivered-prefix snapshot size per rescue scan
    RESCUE_WINDOW_MIN = 4096
    #: bounded end-of-stream join (see _Runner.join)
    JOIN_TIMEOUT_S = 30.0

    def _rescue(self, sink, held, a, b) -> None:
        """If the path owning the next-to-deliver sequence has made no
        progress for STALL_RESCUE_S and the other path is idle, re-submit
        the stranded prefix to the idle path (duplicates are dropped at
        the sink; both paths are exact, so results are identical)."""
        now = time.monotonic()
        for owner, other in ((a, b), (b, a)):
            # windowed over UNDELIVERED entries only (see stuck_prefix)
            window = max(
                self.RESCUE_WINDOW_MIN, self.RESCUE_BLOCKS * self.BLOCK_READS
            )
            seqs = owner.stuck_prefix(window, nxt=sink.next)
            if not seqs or seqs[0] != sink.next:
                continue
            with owner.lock:
                wedged = owner.rescues_since_progress > 0
                delay = (
                    self.STALL_RETRIGGER_S if wedged else self.STALL_RESCUE_S
                )
                stalled = now - owner.last_progress_t >= delay
            if not stalled or not other.idle():
                return
            block = [
                (s, held[s][0], held[s][1])
                for s in seqs[: self.RESCUE_BLOCKS * self.BLOCK_READS]
                if s in held
            ]
            if not block:
                return
            print(
                f"# ntlink hybrid: {owner.name} path quiet for "
                f"{now - owner.last_progress_t:.0f}s holding the stream's "
                f"next result; re-running {len(block)} item(s) on the idle "
                f"{other.name} path",
                file=sys.stderr,
            )
            other.submit(block)
            with owner.lock:
                owner.rescues_since_progress += 1
                owner.last_progress_t = now  # rate-limit repeat rescues
            return

class HybridMapper(HybridStream):
    """Split one read stream across a TorchMapper and a HostMapper."""

    def __init__(self, device_mapper, host_mapper, host_frac: float = -1.0):
        super().__init__(device_mapper, host_mapper, host_frac)
        self.contig_names = device_mapper.contig_names
        self._contig_order = device_mapper._contig_order
        # both paths must agree on the payload contract (raw anchors vs
        # pre-chained accepted anchors) — the caller constructs the host
        # mapper to match the device mapper's mode
        self.prechained = getattr(device_mapper, "prechained", False)
        assert self.prechained == getattr(host_mapper, "prechained", False)
        self.runs_only = getattr(device_mapper, "runs_only", False)
        assert self.runs_only == getattr(host_mapper, "runs_only", False)

    def map_stream_raw(
        self, named_codes: Iterable[Tuple[str, object]]
    ) -> Iterator[Tuple[str, int, Optional[tuple]]]:
        yield from self.stream(named_codes)
