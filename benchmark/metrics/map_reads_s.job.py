"""Seconds per job in the program's `pair/map-reads` span (Tracer)."""


def read(run):
    jobs = run.counters.get("jobs") or []
    if not jobs:
        return None
    return sum(j["spans"].get("pair/map-reads", 0.0) for j in jobs) / len(jobs)
