"""The bucket join's share of its roofline over the traced window: the
least time the join could take, one DRAM sector read for each minimizer
of the read bases fed (``join.json``; 2 / (w + 1) minimizers a base) at
``roofline.json``'s HBM bandwidth, over the device time of the join's
table-gather kernels (names matching ``join.json``'s patterns, overlaps
counted once). The least time comes from the bases fed, so it does not
depend on how the join is built."""
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def least_seconds(bases: float, w: int, join: dict, rf: dict) -> float:
    nbytes = bases * 2.0 / (w + 1) * join["sector_bytes_per_minimizer"]
    return nbytes / rf["hbm_bytes_per_s"]


def read(run):
    t = run.window_trace
    bases = run.counters.get("read_bases", 0)
    if t is None or not bases:
        return None
    with open(os.path.join(HERE, "join.json")) as fh:
        join = json.load(fh)
    kernel_s = t.busy_s("|".join(join["table_gather"]), kernels_only=True)
    if kernel_s <= 0:
        return None
    with open(os.path.join(HERE, "roofline.json")) as fh:
        rf = json.load(fh)
    least = least_seconds(bases, run.config["ntlink"]["w"], join, rf)
    return 100.0 * least / kernel_s
