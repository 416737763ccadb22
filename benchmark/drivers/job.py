"""Window of whole isolate jobs: `pipeline.run_scaffold` (target
`scaffold`, no gap fill) back to back, one client, each job in a directory
of its own that links the draft and the reads of one of the isolates that
set-up made, cycled. Nothing is reused between jobs: each sketches, builds
its index and mapper, captures its own step graphs and runs the host
stages. A job's files are hashed and deleted after it.

Set-up runs one job, which builds the kernels. The check runs the whole
job in the reference for one isolate drawn from the seed among those that
ran, and holds each of its jobs file by file against it, and every other
job against the first job of its isolate.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import time

from benchmark import gen
from benchmark.reference import job as ref_job
from benchmark.trace import marker

from ntlink_tpu_torch import pipeline, step_graph, tracing
from ntlink_tpu_torch.config import ScaffoldConfig


def setup(run):
    cfg, mix = run.config, run.mix
    isolates = []
    for i in range(int(mix["isolates"])):
        seed = int(gen.rng_for(run.seed, "isolate", str(i)).integers(1 << 62))
        genome = gen.make_genome(cfg, seed)
        draft = gen.cut_draft(cfg, genome, seed)
        lengths = gen.read_lengths(mix["reads"],
                                   int(mix["coverage"]) * len(genome),
                                   cfg["name"], run.cell.name)
        reads = gen.make_reads(mix["reads"], lengths, genome, seed,
                               run.cell.name)
        d = run.path(f"isolate{i}")
        os.makedirs(d)
        gen.write_fasta(os.path.join(d, "target.fa"), draft.names,
                        draft.seqs)
        gen.write_fastq(os.path.join(d, "reads.fq"), reads)
        isolates.append({"dir": d, "draft": draft, "reads": reads})
    st = {"isolates": isolates, "jobs": []}
    if run.control:
        return st
    if run.trace:
        tracer = tracing.enable()
        stage = tracer.stage

        @contextlib.contextmanager
        def marked_stage(name):
            with marker(run.profiler, name), stage(name):
                yield

        tracer.stage = marked_stage
    one_job(run, st, "warm", 0)
    return st


def one_job(run, st, tag: str, isolate: int) -> float:
    """One job in a fresh directory; keeps its files' digests, spans and
    graph counts, deletes its files, returns its wall seconds."""
    src = st["isolates"][isolate]["dir"]
    d = run.path(f"job-{tag}")
    os.makedirs(d)
    for name in ("target.fa", "reads.fq"):
        os.symlink(os.path.join(src, name), os.path.join(d, name))
    cfg = ScaffoldConfig(target=os.path.join(d, "target.fa"),
                         reads=[os.path.join(d, "reads.fq")],
                         **run.config["ntlink"])
    spans0 = len(tracing.GLOBAL.spans)
    t = time.perf_counter()
    pipeline.run_scaffold(cfg, gap_fill=False, device=run.device)
    dt = time.perf_counter() - t
    sk = pipeline.last_sketcher
    sketch_graphs = getattr(getattr(sk, "device_backend", sk), "graphs",
                            None)
    spans = {}
    for s in tracing.GLOBAL.spans[spans0:]:
        spans[s.name] = spans.get(s.name, 0.0) + s.wall_s
    st["jobs"].append({
        "tag": tag, "isolate": isolate, "seconds": dt, "spans": spans,
        "graphs": step_graph.counts(
            [rep.graphs for rep in pipeline.last_mapper._replicas]
            + [sketch_graphs]),
        "files": ref_job.digests(d)})
    shutil.rmtree(d)
    return dt


def window(run, st):
    first = len(st["jobs"])
    n_iso = len(st["isolates"])
    start = time.perf_counter()
    while True:
        j = len(st["jobs"]) - first
        with marker(run.profiler, f"job {j}"):
            one_job(run, st, str(j), j % n_iso)
        if time.perf_counter() - start >= run.seconds:
            break
    done = st["jobs"][first:]
    run.e2e["job_s"] = sum(j["seconds"] for j in done) / len(done)
    run.units = (len(done), 0)
    run.counters["jobs"] = done
    run.counters["unit_seconds"] = [j["seconds"] for j in done]


def release(run, st):
    import torch

    pipeline.last_mapper = pipeline.last_hybrid = None
    pipeline.last_sketcher = None
    if run.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check(run, st):
    ran = sorted({j["isolate"] for j in st["jobs"]}) or [0]
    pick = ran[int(gen.rng_for(run.seed, "sample", "isolate").integers(
        len(ran)))]
    iso = st["isolates"][pick]
    d = run.path("reference")
    os.makedirs(d)
    os.symlink(os.path.join(iso["dir"], "target.fa"),
               os.path.join(d, "target.fa"))
    bits = int(run.config.get("control_key_bits", 32)) if run.control else 64
    ref_job.run_job(d, iso["draft"], iso["reads"], run.config["ntlink"],
                    key_bits=bits)
    want = ref_job.digests(d)
    if run.control:
        # the control in the program's place: one job of its own
        ctl = dict(want)
        d64 = run.path("reference64")
        os.makedirs(d64)
        os.symlink(os.path.join(iso["dir"], "target.fa"),
                   os.path.join(d64, "target.fa"))
        ref_job.run_job(d64, iso["draft"], iso["reads"], run.config["ntlink"])
        want = ref_job.digests(d64)
        jobs = [{"isolate": pick, "files": ctl}]
    else:
        jobs = st["jobs"]

    def differing(a, b):
        return sum(a.get(f) != b.get(f) for f in set(a) | set(b))

    parts = [("job_files",
               sum(differing(j["files"], want) for j in jobs
                   if j["isolate"] == pick))]
    if run.control:
        return parts
    firsts = {}
    for j in jobs:
        firsts.setdefault(j["isolate"], j["files"])
    parts.append(("jobs_disagreeing",
                   sum(j["files"] != firsts[j["isolate"]] for j in jobs)))
    return parts
