"""Share of the traced window in which the device ran no kernel, copy or
set (the profiler's device intervals, overlaps counted once)."""


def read(run):
    t = run.window_trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
