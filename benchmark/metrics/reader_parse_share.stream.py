"""Share of the read stream's wall that the reader thread spent parsing
records (`PhaseTimer` key ``reader_parse``, timed on the parser thread of
``seqio.fastx.prefetch_files``, NTLINK_TIMING=1), over the window's passes;
nothing where the program has no such key. Beside
``reader_pull_share.stream`` it tells a slow parser from the hand-off."""


def read(run):
    timing = run.counters.get("timing") or {}
    wall = run.counters.get("stream_s", 0.0)
    if "reader_parse" not in timing or wall <= 0:
        return None
    return 100.0 * timing["reader_parse"][0] / wall
