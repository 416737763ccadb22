"""Share of the read stream's wall that the main thread spent outside every
key it times (`PhaseTimer.THREADS["producer"]`, NTLINK_TIMING=1), over the
window's passes: the consumer's per-read loop and whatever no key holds.
Nothing where the program does not time ``read_prep``."""
from ntlink_tpu_torch.stream_pipeline import PhaseTimer


def read(run):
    timing = run.counters.get("timing") or {}
    wall = run.counters.get("stream_s", 0.0)
    if "read_prep" not in timing or wall <= 0:
        return None
    keyed = sum(timing[k][0] for k in PhaseTimer.THREADS["producer"]
                if k in timing)
    return 100.0 * (wall - keyed) / wall
