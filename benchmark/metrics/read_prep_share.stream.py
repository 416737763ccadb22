"""Share of the read stream's wall that the main thread spent in
`map_stream_raw`'s own work outside its other keys: each read's encode
check, bucketing, pending bookkeeping and in-order delivery (`PhaseTimer`
key ``read_prep``, NTLINK_TIMING=1), over the window's passes; nothing
where the program has no such key."""


def read(run):
    timing = run.counters.get("timing") or {}
    wall = run.counters.get("stream_s", 0.0)
    if "read_prep" not in timing or wall <= 0:
        return None
    return 100.0 * timing["read_prep"][0] / wall
