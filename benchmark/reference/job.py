"""ntLink's `scaffold` target (no gap fill) in plain Python over the frozen
host stages: the files a job writes, from the draft and the reads the
benchmark made, as ntLink's flow names them.
"""
from __future__ import annotations

import os
from typing import Dict

from . import nthash, ntlink
from .flow.config import ScaffoldConfig
from .flow.graphio import graph_from_tally, largest_ntlink_id, read_dot, \
    write_dot
from .flow.layout import run_n_sweep
from .flow.merge import merge_contigs
from .flow.overlap import overlap_stage
from .flow.pairs import PairTally
from .flow.stitch import stitch


def run_job(workdir: str, draft, reads, knobs: dict, key_bits: int = 64,
            threads: int = 8) -> None:
    """Write the job's files into `workdir`, which holds the draft as
    ``target.fa``: the contig sketch TSV, the verbose mapping, the scaffold
    graph, the stitched paths, the overlap trim's files and the merged
    scaffolds. `key_bits` < 64 is the control's index."""
    cfg = ScaffoldConfig(target=os.path.join(workdir, "target.fa"),
                         reads=[], **knobs)
    k, w, z = cfg.k, cfg.w, cfg.z
    prefix = cfg.resolved_prefix()
    sketches = nthash.sketch_many(draft.seqs, k, w, threads=threads)
    with open(f"{cfg.target}.k{k}.w{w}.tsv", "wb") as fh:
        for name, sk in zip(draft.names, sketches):
            fh.write(ntlink.tsv_line(name, sk))
    index = ntlink.Index(draft.names, sketches, key_bits=key_bits)
    lengths = draft.lengths
    tally = PairTally(lengths, k, cfg.f)
    read_sketches = nthash.sketch_many(
        [reads.seq(i) for i in range(len(reads.names))], k, w,
        threads=threads)
    with open(f"{prefix}.verbose_mapping.tsv", "wb") as fh:
        for i, name in enumerate(reads.names):
            runs = ntlink.map_read(reads.seq(i), index, lengths, k, w, z,
                                   sketch=read_sketches[i])
            if runs:
                fh.write(ntlink.verbose_lines(name, runs))
                tally.add_read(runs, int(reads.lengths[i]))
    tally.filter_distances()
    tally.filter_weak_anchors(cfg.a)
    graph = graph_from_tally(tally, lengths).filtered_by_weight(int(cfg.n))
    dot = f"{prefix}.n{cfg.n}.scaffold.dot"
    write_dot(graph, dot, largest_ntlink_id(lengths.keys()))
    graph = read_dot(dot)
    sweep = run_n_sweep(graph, lengths, cfg.n, cfg.max_n, cfg.z, cfg.g,
                        prefix, threads=1)
    stitch_path = f"{prefix}.stitch.path"
    stitch(sweep, graph, stitch_path, max_gap=cfg.G,
           conservative=cfg.conservative)
    for f in sweep:
        os.unlink(f)
        os.unlink(f + ".sterr")
    trimmed = overlap_stage(cfg, dot, stitch_path)
    merge_contigs(trimmed, f"{prefix}.trimmed_scafs.path",
                  f"{cfg.target}.k{k}.w{w}.z{z}.stitch.abyss-scaffold.fa")


def digests(workdir: str) -> Dict[str, str]:
    """sha1 of every regular file of a job directory but its inputs and
    traces, by name."""
    import hashlib

    out = {}
    for name in sorted(os.listdir(workdir)):
        path = os.path.join(workdir, name)
        if (os.path.islink(path) or not os.path.isfile(path)
                or name in ("target.fa", "reads.fq")
                or name.endswith(".trace.json")):
            continue
        h = hashlib.sha1()
        with open(path, "rb") as fh:
            for block in iter(lambda: fh.read(1 << 24), b""):
                h.update(block)
        out[name] = h.hexdigest()
    return out
