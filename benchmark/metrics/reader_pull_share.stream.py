"""Share of the read stream's wall that the main thread spent pulling reads
from the parser (`PhaseTimer` key ``reader_pull``, NTLINK_TIMING=1), over
the window's passes."""


def read(run):
    timing = run.counters.get("timing") or {}
    wall = run.counters.get("stream_s", 0.0)
    if "reader_pull" not in timing or wall <= 0:
        return None
    return 100.0 * timing["reader_pull"][0] / wall
