"""Seconds per rebuild from the first path's last result to the second's in
the hybrid contig sketch (the program's span ``contig-sketch/tail``, v=1
in a traced run): the scheduler's imbalance between the card and the C
threads. The window's rebuilds are the last spans of that name, one per
rebuild; nothing where the program records no such span."""
from ntlink_tpu_torch import tracing

SPAN = "contig-sketch/tail"


def read(run):
    n = len(run.counters.get("rebuilds") or [])
    walls = [s.wall_s for s in tracing.GLOBAL.spans if s.name == SPAN]
    if n == 0 or len(walls) < n:
        return None
    return sum(walls[-n:]) / n
