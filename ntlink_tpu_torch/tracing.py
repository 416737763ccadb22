"""Per-stage tracing: wall time, CPU time, peak RSS, device profile hook.

The reference tracks per-stage time/RSS externally via GNU `time -v` when
`v=1` (reference ntLink:100-110); here tracing is in-process: every pipeline
stage runs under a `stage()` span, and the collected spans are printed and
written to `<prefix>.trace.json`. Counterpart of ``ntlink_tpu/tracing.py``;
its device-profile hook is ``torch.profiler`` here: setting
`NTLINK_TORCH_PROFILE=<dir>` (or `torch_profile_dir` on the tracer)
captures the CPU and, where there is a card, the CUDA activities around
each traced top-level stage and exports one Chrome trace per stage,
`<dir>/<stage>/trace.json` (a stage name's "/" makes a directory level, as
in the JAX package). The steps' `torch.profiler.record_function` ranges
(`mapping_step`, `chain`) name the device work by stage there. A profile
that was asked for and cannot start or be written is an error, not a
silent skip.

Spans nest: a span opened inside another on the same thread names it as
its `parent`, and carries its `start_ns` on ``time.time_ns()``, which is
the clock of a ``torch.profiler`` Chrome trace (an event's `ts` plus the
trace's `baseTimeNanoseconds` / 1e3, in microseconds), and its `thread`.
While any ``torch.profiler`` records, every span also opens a
`record_function` range ``ntlink/<name>`` (`open_range`), so that it lies
on the device trace's timeline beside the kernels; with no profiler
recording no range is opened. `add` records a span whose interval was
measured elsewhere (the sum of a stage's pieces, or a worker path's first
and last block); such a span opens no range. `count` records named
counts (`Count`: a built table's layout at ``table/build``, a read
stream's join counts at ``map/join``, its drainer's decoded blocks and
rows at ``map/decode``, the anchors and bytes of its verbose lines at
``render/verbose``), in the order they were taken, so
that they can be read after the objects that kept them are gone.

A replayed CUDA graph records none of those ranges, so while a profile
may be taken (`profiling`: NTLINK_TORCH_PROFILE, or a profile directory on
`GLOBAL`) the mapping and sketch steps run eagerly, as on the CPU, and
`stage_device_times` reads the split by stage; otherwise a CUDA device
replays one graph per batch (``step_graph``). A profile of replays (the
bench's busy share) still holds every kernel and copy, outside any range.
"""
from __future__ import annotations

import contextlib
import json
import os
import resource
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

#: prefix of the program's `record_function` ranges
RANGE_PREFIX = "ntlink/"


def open_range(name: str):
    """A `record_function` range ``ntlink/<name>``, entered, while a
    ``torch.profiler`` records in this process; None otherwise (and when
    torch was never imported). Close it with `close_range`."""
    prof = sys.modules.get("torch.autograd.profiler")
    # the module's flag is set for every thread while a profiler records
    # (the C check is per thread, and off under profile_all_threads)
    if prof is None or not prof._is_profiler_enabled:
        return None
    rf = prof.record_function(RANGE_PREFIX + name)
    rf.__enter__()
    return rf


def close_range(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


@dataclass
class Span:
    name: str
    wall_s: float
    cpu_s: float
    max_rss_kb: int
    #: its start on ``time.time_ns()``, the clock of a torch profile
    start_ns: int = 0
    #: the name of the span open around it on its thread, or None
    parent: Optional[str] = None
    thread: str = ""


@dataclass
class Count:
    name: str
    values: Dict[str, int]


class Tracer:
    """Collects stage spans and counts; no-op when disabled."""

    def __init__(self, enabled: bool = False,
                 torch_profile_dir: Optional[str] = None):
        self.enabled = enabled
        self.spans: List[Span] = []
        self.counts: List[Count] = []
        self.torch_profile_dir = torch_profile_dir or os.environ.get(
            "NTLINK_TORCH_PROFILE"
        )
        #: a CUDA device whose peak allocated bytes over each top-level
        #: stage go to `device_peak_bytes` by stage name (the spans and
        #: their JSON stay those of the JAX package)
        self.device = None
        self.device_peak_bytes: Dict[str, int] = {}
        #: each thread's open span names, innermost last
        self._open = threading.local()

    def _stack(self) -> List[str]:
        stack = getattr(self._open, "names", None)
        if stack is None:
            stack = self._open.names = []
        return stack

    def _start_profile(self, name: str):
        """Start a ``torch.profiler`` capture for stage `name`; returns
        (profiler, path of the Chrome trace it will write)."""
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        out_dir = os.path.join(self.torch_profile_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        # the device calls of a stage run on the streams' feeder threads,
        # which are started after the profiler: trace every thread
        prof = profile(
            activities=activities,
            experimental_config=_ExperimentalConfig(profile_all_threads=True),
        )
        prof.start()
        return prof, os.path.join(out_dir, "trace.json")

    @contextlib.contextmanager
    def stage(self, name: str):
        """A span around the block; nested in the span open on this thread,
        if any. Only a top-level span takes a per-stage profile and the
        device's peak memory."""
        if not self.enabled:
            yield
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        prof = None
        if parent is None and self.torch_profile_dir:
            prof, trace_path = self._start_profile(name)
        peak = parent is None and self.device is not None
        if peak:
            import torch

            torch.cuda.reset_peak_memory_stats(self.device)
        rf = open_range(name)
        stack.append(name)
        t0 = time.time_ns()
        c0 = time.process_time()
        try:
            yield
        finally:
            wall = (time.time_ns() - t0) / 1e9
            cpu = time.process_time() - c0
            stack.pop()
            close_range(rf)
            if peak:
                self.device_peak_bytes[name] = torch.cuda.max_memory_allocated(
                    self.device)
            if prof is not None:
                prof.stop()
                prof.export_chrome_trace(trace_path)
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            self.spans.append(Span(name, wall, cpu, rss, t0, parent,
                                   threading.current_thread().name))

    def add(self, name: str, start_ns: int, wall_s: float,
            cpu_s: float = 0.0) -> None:
        """Record a span measured elsewhere: `wall_s` seconds from
        `start_ns` (``time.time_ns()``), nested in the span open on this
        thread, if any. It opens no range."""
        if not self.enabled:
            return
        stack = self._stack()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        self.spans.append(Span(name, wall_s, cpu_s, rss, int(start_ns),
                               stack[-1] if stack else None,
                               threading.current_thread().name))

    def count(self, name: str, **values: int) -> None:
        """Record the counts `values` under `name`."""
        if self.enabled:
            self.counts.append(Count(name, dict(values)))

    def counts_named(self, name: str) -> List[Dict[str, int]]:
        """The values of every count recorded under `name`, oldest
        first."""
        return [c.values for c in self.counts if c.name == name]

    def ordered(self) -> List[Span]:
        """The spans by start, a span before those it holds."""
        return sorted(self.spans, key=lambda s: (s.start_ns, -s.wall_s))

    def report(self, out=sys.stdout) -> None:
        """The spans by start, each nested span indented under its parent;
        the total is that of the top-level spans."""
        if not self.enabled or not self.spans:
            return
        total = sum(s.wall_s for s in self.spans if s.parent is None)
        print("\nStage trace:", file=out)
        ends: Dict[str, List[int]] = {}  # thread -> ends of open spans
        for s in self.ordered():
            open_ = ends.setdefault(s.thread, [])
            if s.parent is None:
                open_.clear()
            while open_ and open_[-1] <= s.start_ns:
                open_.pop()
            pad = "  " * len(open_)
            print(
                f"  {pad}{s.name:<{24 - len(pad)}} wall {s.wall_s:8.2f}s  "
                f"cpu {s.cpu_s:8.2f}s  peak-rss {s.max_rss_kb/1024:8.1f} MB",
                file=out,
            )
            open_.append(s.start_ns + int(s.wall_s * 1e9))
        print(f"  {'TOTAL':<24} wall {total:8.2f}s", file=out)

    def write_json(self, path: str) -> None:
        if not self.enabled:
            return
        with open(path, "w") as fh:
            json.dump(
                [s.__dict__ for s in self.ordered()], fh, indent=1
            )


#: process-wide tracer; pipeline stages use this unless given another
GLOBAL = Tracer(enabled=False)


def profiling() -> bool:
    """Whether a device profile may be taken in this process: a profile
    directory on `GLOBAL` (NTLINK_TORCH_PROFILE at import, `enable`) or
    NTLINK_TORCH_PROFILE set since. The device steps then run eagerly
    (``step_graph.for_device``)."""
    return bool(GLOBAL.torch_profile_dir
                or os.environ.get("NTLINK_TORCH_PROFILE"))


def enable(torch_profile_dir: Optional[str] = None) -> Tracer:
    GLOBAL.enabled = True
    if torch_profile_dir:
        GLOBAL.torch_profile_dir = torch_profile_dir
    return GLOBAL


def stage_device_times(trace_path: str) -> dict:
    """Device time by `record_function` range, from one Chrome trace that
    the profile hook wrote on a card. A kernel or copy on the device
    belongs to the innermost range whose device-side annotation spans it
    on its stream (ranges nest: "chain/accept" holds its phases). Returns
    {"stages": {range name: {"us": device microseconds of its kernels and
    copies, "events": their count}}, "unattributed_us": device time
    outside every range, "total_us": all of it, "kernels": {kernel name:
    microseconds}}. `total_us` and `unattributed_us` are each the union
    of their intervals on each device (a trace's `pid`), summed over the
    devices: work that overlaps on two streams counts once, so that
    `total_us` over a window's wall is the device's busy share."""
    import bisect
    import itertools

    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges: dict = {}   # (pid, tid) -> [(start, end, name)], by start
    work = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "gpu_user_annotation":
            ranges.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            work.append(e)
    starts, reach = {}, {}
    for key, spans in ranges.items():
        # by start, an enclosing range before the ranges it holds
        spans.sort(key=lambda s: (s[0], -s[1]))
        starts[key] = [s[0] for s in spans]
        # the latest end of any range that starts at or before each one
        reach[key] = list(itertools.accumulate((s[1] for s in spans), max))
    out = {"stages": {}, "unattributed_us": 0.0, "total_us": 0.0,
           "kernels": {}}
    busy: dict = {}     # (pid, attributed) -> [(start, end)]
    for e in work:
        key = (e["pid"], e["tid"])
        name = None
        if key in ranges:
            end = e["ts"] + e["dur"]
            i = bisect.bisect_right(starts[key], e["ts"]) - 1
            # back from the latest range that starts before the event, as
            # long as a range that far back can still reach past its end
            while i >= 0 and end <= reach[key][i] + 1e-3:
                if end <= ranges[key][i][1] + 1e-3:
                    name = ranges[key][i][2]
                    break
                i -= 1
        busy.setdefault((e["pid"], name is not None), []).append(
            (e["ts"], e["ts"] + e["dur"]))
        if e.get("cat") == "kernel":
            out["kernels"][e["name"]] = (
                out["kernels"].get(e["name"], 0.0) + e["dur"])
        if name is None:
            continue
        stage = out["stages"].setdefault(name, {"us": 0.0, "events": 0})
        stage["us"] += e["dur"]
        stage["events"] += 1
    for pid in {pid for pid, _ in busy}:
        out["total_us"] += _union_us(busy.get((pid, True), [])
                                     + busy.get((pid, False), []))
        out["unattributed_us"] += _union_us(busy.get((pid, False), []))
    return out


def _union_us(intervals) -> float:
    """Length of the union of [start, end) intervals: overlaps count
    once."""
    total, reach = 0.0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total
