"""Step-graph captures per job: the job's read mapper
(`TorchMapper.graph_counts`) and contig sketcher (its card path's graphs)."""


def read(run):
    jobs = run.counters.get("jobs") or []
    if not jobs or any(j["graphs"] is None for j in jobs):
        return None
    return sum(j["graphs"][0] for j in jobs) / len(jobs)
