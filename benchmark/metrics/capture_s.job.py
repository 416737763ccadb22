"""Seconds per job spent capturing step graphs (the mapper's and the
contig sketcher's `step_graph` counts)."""


def read(run):
    jobs = run.counters.get("jobs") or []
    if not jobs or any(j["graphs"] is None for j in jobs):
        return None
    return sum(j["graphs"][2] for j in jobs) / len(jobs)
