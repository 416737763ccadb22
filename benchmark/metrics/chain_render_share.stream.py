"""Share of the read stream's wall that the main thread spent in the
consumer's C chaining and verbose rendering, one `chain_batch` call per
read group (`PhaseTimer` key ``chain_render``, NTLINK_TIMING=1), over the
window's passes; nothing where the program has no such key."""


def read(run):
    timing = run.counters.get("timing") or {}
    wall = run.counters.get("stream_s", 0.0)
    if "chain_render" not in timing or wall <= 0:
        return None
    return 100.0 * timing["chain_render"][0] / wall
