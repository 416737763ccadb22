"""Per-stage tracing: wall time, CPU time, peak RSS.

The reference tracks per-stage time/RSS externally via GNU `time -v` when
`v=1` (reference ntLink:100-110); here tracing is in-process: every pipeline
stage runs under a `stage()` span, and the collected spans are printed and
written to `<prefix>.trace.json`. Counterpart of ``ntlink_tpu/tracing.py``
without its device-profile hook: the port's entry points refuse `v>0`
(`pipeline.check_supported`), so the tracer stays disabled and `stage()` is
a no-op around the host stages that enter it.
"""
from __future__ import annotations

import contextlib
import json
import resource
import sys
import time
from dataclasses import dataclass
from typing import List


@dataclass
class Span:
    name: str
    wall_s: float
    cpu_s: float
    max_rss_kb: int


class Tracer:
    """Collects stage spans; no-op when disabled."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.spans: List[Span] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.time()
        c0 = time.process_time()
        try:
            yield
        finally:
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            self.spans.append(
                Span(name, time.time() - t0, time.process_time() - c0, rss)
            )

    def report(self, out=sys.stdout) -> None:
        if not self.enabled or not self.spans:
            return
        total = sum(s.wall_s for s in self.spans)
        print("\nStage trace:", file=out)
        for s in self.spans:
            print(
                f"  {s.name:<24} wall {s.wall_s:8.2f}s  cpu {s.cpu_s:8.2f}s  "
                f"peak-rss {s.max_rss_kb/1024:8.1f} MB",
                file=out,
            )
        print(f"  {'TOTAL':<24} wall {total:8.2f}s", file=out)

    def write_json(self, path: str) -> None:
        if not self.enabled:
            return
        with open(path, "w") as fh:
            json.dump(
                [s.__dict__ for s in self.spans], fh, indent=1
            )


#: process-wide tracer; pipeline stages use this unless given another
GLOBAL = Tracer(enabled=False)


def enable() -> Tracer:
    GLOBAL.enabled = True
    return GLOBAL
