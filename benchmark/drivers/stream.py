"""Window of a read stream: `pipeline.map_reads` over one pass of reads,
replayed back to back, against a contig index built once in set-up as
`pipeline.pair_stage` builds it (``ensure_contig_sketch_tsv``,
``ContigIndex.from_tsv``, ``make_mapper``).

Set-up maps the whole pass twice: a step graph is captured at its key's
second batch, and a key holds the batch's height, which the stream's
partial flushes set, so some keys occur once a pass and no subset of the
pass meets them. After two passes every key of the pass replays.

Each pass's verbose mapping is hashed as soon as the pass ends, outside
its time, and the one before it is deleted, so that the window leaves one
pass's file, and no file is old enough to be written back to disk while
the window runs. The check holds every pass's digests against the last
pass's, the contig sketch TSV and a sample of the last pass's reads
against the reference, and the last pass's tally against a tally of its
verbose lines.
"""
from __future__ import annotations

import os
import sys
import time

from benchmark import gen, judge
from benchmark.reference import ntlink
from benchmark.trace import marker

from ntlink_tpu_torch import pipeline, tracing
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.index import ContigIndex

#: whole passes mapped in set-up (see the module's text)
WARM_PASSES = 2


def make_data(run):
    """Genome, draft (written as target.fa) and one pass of reads (written
    as reads.fq) of the run's seed."""
    cfg, mix = run.config, run.mix
    genome = gen.make_genome(cfg, run.seed)
    draft = gen.cut_draft(cfg, genome, run.seed)
    gen.write_fasta(run.path("target.fa"), draft.names, draft.seqs)
    lengths = gen.read_lengths(mix["reads"], mix["pass_bases"],
                               cfg["name"], run.cell.name)
    reads = gen.make_reads(mix["reads"], lengths, genome, run.seed,
                           run.cell.name)
    gen.write_fastq(run.path("reads.fq"), reads)
    return draft, reads


def scaffold_config(run, reads_path: str) -> ScaffoldConfig:
    return ScaffoldConfig(target=run.path("target.fa"), reads=[reads_path],
                          **run.config["ntlink"])


def setup(run):
    draft, reads = make_data(run)
    st = {"draft": draft, "reads": reads}
    if run.control:
        return st
    if run.trace:
        tracing.enable()
    cfg = scaffold_config(run, run.path("reads.fq"))
    sketch_device, devices = pipeline.split_devices(cfg, run.device)
    tsv = pipeline.ensure_contig_sketch_tsv(cfg, cfg.k, cfg.w,
                                            device=sketch_device)
    index = ContigIndex.from_tsv(tsv)
    lengths = pipeline.read_scaffold_lengths(cfg.target)
    mapper = pipeline.make_mapper(cfg, index, lengths, devices)
    st.update(cfg=cfg, tsv=tsv, index=index, lengths=lengths, mapper=mapper,
              passes=[])
    for i in range(WARM_PASSES):
        one_pass(run, st, f"warm{i}")
    return st


def one_pass(run, st, tag: str) -> float:
    """One pass through `map_reads`; keeps the digests of its verbose
    mapping and its tally, deletes the verbose mapping of the pass before,
    returns its wall seconds."""
    verbose = run.path(f"verbose.{tag}.tsv")
    m = st["mapper"]
    t0 = m.stream_seconds
    t, c = time.perf_counter(), time.process_time()
    tally = pipeline.map_reads(st["cfg"], st["index"], st["lengths"],
                               verbose, None, st["mapper"])
    dt = time.perf_counter() - t
    st["passes"].append({"tag": tag, "verbose": verbose, "seconds": dt,
                         "cpu_s": time.process_time() - c,
                         "digest": judge.file_digest(verbose),
                         "tally": ntlink.tally_digest(tally),
                         "stream_s": m.stream_seconds - t0,
                         "timing": dict(m.last_timing)})
    if len(st["passes"]) > 1:
        os.remove(st["passes"][-2]["verbose"])
    return dt


def window(run, st):
    m = st["mapper"]
    graphs0 = m.graph_counts()
    first = len(st["passes"])
    start = time.perf_counter()
    while True:
        i = len(st["passes"]) - first
        with marker(run.profiler, f"map_reads pass {i}"):
            one_pass(run, st, f"pass{i}")
        if time.perf_counter() - start >= run.seconds:
            break
    done = st["passes"][first:]
    after = m.graph_counts()
    if after is not None:
        print(f"# bench step graphs in the window: "
              f"{after[0] - graphs0[0]} captured, "
              f"{after[1] - graphs0[1]} replays", file=sys.stderr)
    secs = sum(p["seconds"] for p in done)
    bases = st["reads"].bases * len(done)
    run.e2e["read_Mbase_per_s"] = bases / secs / 1e6
    run.units = (len(done), 0)
    timing = {}
    for p in done:
        for key, (s, n) in p["timing"].items():
            s0, n0 = timing.get(key, (0.0, 0))
            timing[key] = (s0 + s, n0 + n)
    run.counters.update(
        unit_seconds=[p["seconds"] for p in done],
        unit_cpu_seconds=[p["cpu_s"] for p in done],
        read_bases=bases, passes=len(done), pass_seconds=secs,
        stream_s=sum(p["stream_s"] for p in done), timing=timing,
        graphs_before=graphs0, graphs_after=after)


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
    draft, reads = st["draft"], st["reads"]
    cfg = run.config["ntlink"]
    k, w, z = cfg["k"], cfg["w"], cfg["z"]
    lengths = draft.lengths
    sketches = judge.draft_sketches(draft, k, w)
    picks = judge.sample(len(reads.names), int(run.mix["sample_reads"]),
                         run.seed, run.cell.name,
                         longest=judge.longest(reads.lengths, 5))
    if run.control:
        program = judge.control_lines(
            reads, picks, judge.control_index(run.config, draft, sketches),
            lengths, k, w, z)
    else:
        last = st["passes"][-1]
        program = ntlink.group_verbose(last["verbose"])
    index = ntlink.Index(draft.names, sketches)
    parts = [("sampled_reads", judge.reads_differing(
        program, reads, picks, index, lengths, k, w, z))]
    if run.control:
        return parts
    parts.append(("tsv_contigs", judge.tsv_differing(
        st["tsv"], draft, sketches, judge.contig_picks(draft, run.seed))))
    read_len = dict(zip(reads.names, reads.lengths.tolist()))
    ref_tally = ntlink.tally_digest(ntlink.tally(
        program, read_len, lengths, k, run.config["ntlink"].get("f", 10)))
    parts.append(("tally_pairs",
                   ntlink.count_differing(last["tally"], ref_tally)))
    digests = [(p["digest"], p["tally"]) for p in st["passes"]]
    parts.append(("passes",
                   sum(d != digests[-1] for d in digests)))
    return parts
