"""Seconds per rebuild in `ContigIndex.from_tsv` (the harness's clock
around the call): the TSV parse and the global dedup."""


def read(run):
    b = run.counters.get("rebuilds") or []
    return sum(r["parse_s"] for r in b) / len(b) if b else None
