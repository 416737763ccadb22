"""Share of the read stream's wall that the main thread spent in the
consumer's pair tally: the `RunView` construction and `PairTally.add_read`
of the reads with two runs or more (`PhaseTimer` key ``tally``,
NTLINK_TIMING=1), over the window's passes; nothing where the program has
no such key."""


def read(run):
    timing = run.counters.get("timing") or {}
    wall = run.counters.get("stream_s", 0.0)
    if "tally" not in timing or wall <= 0:
        return None
    return 100.0 * timing["tally"][0] / wall
