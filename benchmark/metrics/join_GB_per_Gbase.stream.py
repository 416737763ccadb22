"""GB of contig-table buckets the bucket join gathered per Gbase of reads
mapped in the traced window: the program's ``map/join`` counts
(`TorchMapper.join_stats`, one count a read stream, with the Tracer on),
the window's passes being the last counts, one a pass. The bytes are the
program's own model of the join's gather (slots x max_probes x 128 B of
bucket rows), not a reading of the card. Nothing where the program records
no such counts."""
from ntlink_tpu_torch import tracing


def read(run):
    n = run.counters.get("passes") or 0
    bases = run.counters.get("read_bases", 0)
    counts_named = getattr(tracing.GLOBAL, "counts_named", None)
    if n == 0 or not bases or counts_named is None:
        return None
    counts = counts_named("map/join")
    if len(counts) < n:
        return None
    return sum(c["bucket_bytes"] for c in counts[-n:]) / bases
