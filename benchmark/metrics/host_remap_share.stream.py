"""Share of the read stream's wall that the main thread spent mapping the
reads that the device does not take on the exact host path (`PhaseTimer`
key ``host_remap``, NTLINK_TIMING=1), over the window's passes: 0 where no
read went there. Nothing where the program does not time ``read_prep``,
which it times beside ``host_remap``."""


def read(run):
    timing = run.counters.get("timing") or {}
    wall = run.counters.get("stream_s", 0.0)
    if "read_prep" not in timing or wall <= 0:
        return None
    return 100.0 * timing.get("host_remap", (0.0, 0))[0] / wall
