"""Share of the read stream's wall that the main thread spent outside its
timed keys (``reader_pull``, ``pack``, ``feed_enqueue_wait``): its per-read
Python, and the consumer's C chaining, verbose rendering and tally, which
run on the same thread between reads."""

KEYS = ("reader_pull", "pack", "feed_enqueue_wait")


def read(run):
    timing = run.counters.get("timing") or {}
    wall = run.counters.get("stream_s", 0.0)
    if not timing or wall <= 0:
        return None
    keyed = sum(timing[k][0] for k in KEYS if k in timing)
    return 100.0 * (wall - keyed) / wall
