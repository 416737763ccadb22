"""Seconds per rebuild in `ensure_contig_sketch_tsv` (the harness's clock
around the call): the contig sketch and its TSV."""


def read(run):
    b = run.counters.get("rebuilds") or []
    return sum(r["sketch_s"] for r in b) / len(b) if b else None
