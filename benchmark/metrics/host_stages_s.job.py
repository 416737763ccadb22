"""Seconds per job in the program's host-stage spans (Tracer):
`layout+stitch`, `overlap-trim` and `merge`."""

SPANS = ("layout+stitch", "overlap-trim", "merge")


def read(run):
    jobs = run.counters.get("jobs") or []
    if not jobs:
        return None
    return sum(j["spans"].get(s, 0.0) for j in jobs for s in SPANS) / len(jobs)
