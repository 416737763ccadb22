"""The traced window: a ``torch.profiler`` capture of the device's kernels
and copies (the step graphs keep replaying: nothing here switches the
program's own profile on), merged into busy intervals, with markers of
what the host was doing.

`merge` counts overlapping intervals once; busy time, idle gaps and the
share of one kernel's time all come from it.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short(name: str, limit: int = 160) -> str:
    """A device op's name cut to `limit` characters (kernel names carry
    whole template signatures)."""
    return name if len(name) <= limit else name[: limit - 3] + "..."


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float,
                                                                  float]]:
    """Union of [start, end) intervals, sorted, overlaps joined."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: Sequence[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The idle stretches of [start, end) between merged busy intervals."""
    out, at = [], start
    for a, b in merge(busy):
        if a > at:
            out.append((at, min(a, end)))
        at = max(at, b)
    if at < end:
        out.append((at, end))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Trace:
    """What a traced window saw, in seconds on the profiler's clock."""

    start: float
    end: float
    #: (name, start, end, category) of every kernel, copy and set on the
    #: device
    ops: List[Tuple[str, float, float, str]] = field(default_factory=list)
    #: (name, start, end) of the host markers
    marks: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy(self, pattern: Optional[str] = None,
             kernels_only: bool = False) -> List[Tuple[float, float]]:
        rx = re.compile(pattern) if pattern else None
        return merge([(a, b) for name, a, b, cat in self.ops
                      if (rx is None or rx.search(name))
                      and (not kernels_only or cat == "kernel")])

    def busy_s(self, pattern: Optional[str] = None,
               kernels_only: bool = False) -> float:
        return sum(b - a for a, b in self.busy(pattern, kernels_only))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b, _ in self.ops:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[short(k), v] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest idle stretches, each named by the innermost host
        marker open at its middle (or "no marker")."""
        out = []
        for a, b in gaps(self.busy(), self.start, self.end):
            mid = 0.5 * (a + b)
            open_ = [(m1 - m0, name) for name, m0, m1 in self.marks
                     if m0 <= mid < m1]
            out.append([min(open_)[1] if open_ else "no marker", b - a])
        out.sort(key=lambda g: -g[1])
        return out[:n]


class Profiler:
    """A ``torch.profiler`` capture of CPU and CUDA activity around the
    window; `mark` opens a named host marker that lands in the trace."""

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.prof = None
        self.trace: Optional[Trace] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        path = os.path.join(self.workdir, "window-trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        with open(path) as fh:
            events = json.load(fh)
        os.remove(path)
        self.trace = read_chrome_trace(events)
        return False

    @contextlib.contextmanager
    def mark(self, name: str):
        from torch.profiler import record_function

        with record_function(f"bench::{name}"):
            yield


@contextlib.contextmanager
def marker(profiler: Optional[Profiler], name: str):
    """`profiler.mark(name)`, or nothing outside a traced run."""
    if profiler is None:
        yield
    else:
        with profiler.mark(name):
            yield


def read_chrome_trace(events) -> Trace:
    """A `Trace` from ``export_chrome_trace``'s JSON: device ops by their
    category, host markers from the ``bench::`` annotations, the window
    from the first to the last of either."""
    evs = events["traceEvents"] if isinstance(events, dict) else events
    ops, marks = [], []
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        name = str(e.get("name", ""))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((name, a, b, cat))
        elif cat == "user_annotation" and name.startswith("bench::"):
            marks.append((name[len("bench::"):], a, b))
    pts = [x for _, a, b, *_ in ops + marks for x in (a, b)]
    t = Trace(min(pts) if pts else 0.0, max(pts) if pts else 0.0, ops, marks)
    window = [m for m in marks if m[0] == "window"]
    if window:
        t.start, t.end = window[0][1], window[0][2]
    return t
