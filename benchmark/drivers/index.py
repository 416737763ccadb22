"""Window of contig-index rebuilds, back to back: each deletes the contig
sketch TSV, then runs `pipeline.ensure_contig_sketch_tsv` (the default
contig sketch), `ContigIndex.from_tsv` and `pipeline.make_mapper` (the
table built and uploaded), synchronises, and drops the mapper, as every
`pair` run and every round of `ntLink_rounds` starts.

Set-up makes one rebuild, which builds the kernels. The check holds every
rebuild's TSV against the last, the last TSV against the reference's
contig sketch, and the last mapper's answers, on probe reads mapped after
the window, against the reference's index.
"""
from __future__ import annotations

import os
import time

from benchmark import gen, judge
from benchmark.reference import ntlink
from benchmark.trace import marker

from ntlink_tpu_torch import pipeline, tracing
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.index import ContigIndex


def setup(run):
    cfg, mix = run.config, run.mix
    genome = gen.make_genome(cfg, run.seed)
    draft = gen.cut_draft(cfg, genome, run.seed)
    gen.write_fasta(run.path("target.fa"), draft.names, draft.seqs)
    lengths = gen.read_lengths(mix["probe_reads"], mix["probe_bases"],
                               cfg["name"], run.cell.name)
    probes = gen.make_reads(mix["probe_reads"], lengths, genome, run.seed,
                            run.cell.name)
    gen.write_fastq(run.path("probes.fq"), probes)
    st = {"draft": draft, "probes": probes, "rebuilds": []}
    if run.control:
        return st
    if run.trace:
        tracing.enable()
    st["cfg"] = ScaffoldConfig(target=run.path("target.fa"),
                               reads=[run.path("probes.fq")],
                               **cfg["ntlink"])
    st["devices"] = pipeline.split_devices(st["cfg"], run.device)
    st["lengths"] = pipeline.read_scaffold_lengths(st["cfg"].target)
    rebuild(run, st)
    return st


def rebuild(run, st) -> float:
    """One rebuild; keeps its TSV's digest and its timings."""
    import torch

    cfg = st["cfg"]
    sketch_device, devices = st["devices"]
    tsv = f"{cfg.target}.k{cfg.k}.w{cfg.w}.tsv"
    if os.path.exists(tsv):
        os.remove(tsv)
    st.pop("mapper", None)
    t0 = time.perf_counter()
    with marker(run.profiler, "contig sketch"):
        tsv = pipeline.ensure_contig_sketch_tsv(cfg, cfg.k, cfg.w,
                                                device=sketch_device)
    t1 = time.perf_counter()
    with marker(run.profiler, "index parse"):
        index = ContigIndex.from_tsv(tsv)
    t2 = time.perf_counter()
    with marker(run.profiler, "table build"):
        mapper = pipeline.make_mapper(cfg, index, st["lengths"], devices)
        if run.device != "cpu":
            torch.cuda.synchronize()
    t3 = time.perf_counter()
    sk = pipeline.last_sketcher
    st["rebuilds"].append({
        "seconds": t3 - t0, "sketch_s": t1 - t0, "parse_s": t2 - t1,
        "table_s": mapper.build_seconds + mapper.upload_seconds,
        "device_bases": getattr(sk, "device_bases", 0),
        "host_bases": getattr(sk, "host_bases", 0),
        "digest": judge.file_digest(tsv)})
    st.update(tsv=tsv, index=index, mapper=mapper)
    return t3 - t0


def window(run, st):
    first = len(st["rebuilds"])
    start = time.perf_counter()
    while True:
        rebuild(run, st)
        if time.perf_counter() - start >= run.seconds:
            break
    done = st["rebuilds"][first:]
    run.e2e["index_s"] = sum(r["seconds"] for r in done) / len(done)
    run.units = (len(done), 0)
    run.counters["rebuilds"] = done
    run.counters["unit_seconds"] = [r["seconds"] for r in done]
    # the last mapper's answers, after the window
    pipeline.map_reads(st["cfg"], st["index"], st["lengths"],
                       run.path("probes.verbose.tsv"), None, st["mapper"])


def release(run, st):
    import torch

    for key in ("mapper", "index"):
        st.pop(key, None)
    pipeline.last_mapper = pipeline.last_hybrid = None
    pipeline.last_sketcher = None
    if run.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def check(run, st):
    draft, probes = st["draft"], st["probes"]
    cfg = run.config["ntlink"]
    k, w, z = cfg["k"], cfg["w"], cfg["z"]
    lengths = draft.lengths
    sketches = judge.draft_sketches(draft, k, w)
    picks = judge.sample(len(probes.names), int(run.mix["sample_reads"]),
                         run.seed, run.cell.name,
                         longest=judge.longest(probes.lengths, 5))
    if run.control:
        program = judge.control_lines(
            probes, picks, judge.control_index(run.config, draft, sketches),
            lengths, k, w, z)
    else:
        program = ntlink.group_verbose(run.path("probes.verbose.tsv"))
    index = ntlink.Index(draft.names, sketches)
    parts = [("sampled_reads", judge.reads_differing(
        program, probes, picks, index, lengths, k, w, z))]
    if run.control:
        return parts
    parts.append(("tsv_contigs", judge.tsv_differing(
        st["tsv"], draft, sketches, judge.contig_picks(draft, run.seed))))
    last = st["rebuilds"][-1]["digest"]
    parts.append(("rebuilds",
                   sum(r["digest"] != last for r in st["rebuilds"])))
    return parts
