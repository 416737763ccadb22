"""Seconds per rebuild that the main thread spent rendering the contig
sketch's TSV and writing it (the program's span ``contig-
sketch/render``: the sum over the contigs, v=1 in a traced run). The
window's rebuilds are the last spans of that name, one per rebuild;
nothing where the program records no such span."""
from ntlink_tpu_torch import tracing

SPAN = "contig-sketch/render"


def read(run):
    n = len(run.counters.get("rebuilds") or [])
    walls = [s.wall_s for s in tracing.GLOBAL.spans if s.name == SPAN]
    if n == 0 or len(walls) < n:
        return None
    return sum(walls[-n:]) / n
