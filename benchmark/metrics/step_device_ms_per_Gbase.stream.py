"""Milliseconds of device kernel time (overlapping kernels counted once)
per Gbase of reads mapped in the traced window."""


def read(run):
    t = run.window_trace
    bases = run.counters.get("read_bases", 0)
    if t is None or not bases:
        return None
    busy = t.busy_s(kernels_only=True)
    if busy <= 0:
        return None
    return 1e3 * busy / (bases / 1e9)
