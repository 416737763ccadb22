"""Share of the read stream's wall that the main thread spent assembling
each read group's flat anchor arrays for the consumer's chaining
(`PhaseTimer` key ``group_gather``, NTLINK_TIMING=1), over the window's
passes; nothing where the program has no such key."""


def read(run):
    timing = run.counters.get("timing") or {}
    wall = run.counters.get("stream_s", 0.0)
    if "group_gather" not in timing or wall <= 0:
        return None
    return 100.0 * timing["group_gather"][0] / wall
