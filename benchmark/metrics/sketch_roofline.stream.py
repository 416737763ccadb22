"""The sketch kernel's share of its roofline over the traced window: the
least time the read bases fed could take on the card (``roofline.json``:
the larger of the 32-bit integer operations the canonical ntHash roll and
the window minimum cannot avoid, and the bytes each base and each selected
minimizer must move) over the time of the kernels whose names match
``kernels.json``'s "sketch" patterns (overlaps counted once). Both counts
come from the bases fed, so they do not depend on the kernel."""
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def least_seconds(bases: float, w: int, rf: dict) -> float:
    s = rf["sketch"]
    ops = bases * s["int32_ops_per_base"]
    nbytes = bases * (s["code_bytes_per_base"]
                      + s["minimizer_bytes"] * 2.0 / (w + 1))
    return max(ops / rf["int32_ops_per_s"], nbytes / rf["hbm_bytes_per_s"])


def read(run):
    t = run.window_trace
    bases = run.counters.get("read_bases", 0)
    if t is None or not bases:
        return None
    with open(os.path.join(HERE, "kernels.json")) as fh:
        pattern = "|".join(json.load(fh)["sketch"])
    kernel_s = t.busy_s(pattern, kernels_only=True)
    if kernel_s <= 0:
        return None
    with open(os.path.join(HERE, "roofline.json")) as fh:
        rf = json.load(fh)
    least = least_seconds(bases, run.config["ntlink"]["w"], rf)
    return 100.0 * least / kernel_s
