"""The stages of ntlink_tpu driven through the PyTorch sketcher and mapper.

Counterpart of ``ntlink_tpu/pipeline.py`` on one device. `pair_stage`
(:492-589) writes the same artifacts under the same names
(``<target>.k<k>.w<w>.tsv``, ``<prefix>.n<n>.scaffold.dot``,
``.verbose_mapping.tsv``, ``.pairs.tsv``, ``.paf``) and reuses the JAX
package's host stages as they are: the TSV writer, the contig index,
`map_reads` with its C chaining and rendering, the pair tally and the graph
writer. The device work is the port's: the contig sketch
(`sketch.TorchSketcher`) and the read mapper (`device_map.TorchMapper`),
which chains on the device and ships O(runs) payloads under the same gates
as ``DeviceMapper`` (`_prechain_args`; runs only without verbose or PAF
output). With backend=hybrid both split their streams with the host's C
path (`sketch.TorchHybridSketcher`, ``hybrid_map.HybridMapper``).

`scaffold_stage`, `run_scaffold` and `run_rounds` (:624-781) are the
reference's flows around the port's `pair_stage`, with the same file names
and symlinks; layout, stitch, overlap trim, merge, gap-fill, liftover and
clean-up are ``ntlink_tpu``'s host code.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List

from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu.graphio import graph_from_tally, largest_ntlink_id, write_dot
from ntlink_tpu.host_map import HostMapper
from ntlink_tpu.hybrid_map import HybridMapper
from ntlink_tpu.index import ContigIndex
from ntlink_tpu.native import chain_module
from ntlink_tpu.pairs import tally_from_checkpoint
from ntlink_tpu.pipeline import (
    _is_fresh,
    _prechain_args,
    _relink,
    clean_artifacts,
    gap_fill_stage,
    layout_and_stitch,
    log,
    map_reads,
    read_scaffold_lengths,
)
from ntlink_tpu.sketch import sketch_fasta_to_tsv

from .device_map import TorchMapper
from .ops import sketch_cuda
from .sketch import TorchHybridSketcher, TorchSketcher

BACKENDS = ("auto", "jax", "hybrid")

#: the TorchMapper of the latest `pair_stage` that mapped reads, the
#: HybridMapper around it (backend=hybrid, else None), and the sketcher of
#: the latest contig sketch (TorchSketcher, or TorchHybridSketcher), for
#: callers of the CLI that read their counts (`host_fallbacks`,
#: `device_reads` / `host_reads`, `batches_by_pad`, `stream_seconds`, ...)
last_mapper = None
last_hybrid = None
last_sketcher = None
#: wall seconds of the latest `pair_stage`'s read mapping (`map_reads`)
last_map_seconds = 0.0
#: sketch kernel launches of each round of the latest `run_rounds`
round_launches: List[int] = []


class NotPorted(ValueError):
    """A configuration the port does not run yet."""


def check_supported(cfg: ScaffoldConfig) -> None:
    """Raise NotPorted for settings whose path is not ported, and
    ValueError for a backend name the reference does not know."""
    if cfg.v > 0:
        raise NotPorted("not yet ported: v (tracing)")
    if cfg.backend == "numpy":
        raise NotPorted(
            "not yet ported: backend=numpy (the port runs on the card; a "
            "host-only run is `python -m ntlink_tpu ... backend=numpy`)"
        )
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend={cfg.backend}")
    if cfg.index_sharding != "replicated":
        raise NotPorted(f"not yet ported: index_sharding={cfg.index_sharding}")
    if cfg.idx_shards:
        raise NotPorted("not yet ported: idx_shards")
    if int(os.environ.get("NTLINK_NUM_PROCESSES", "0") or 0) > 1:
        raise NotPorted("not yet ported: multi-process runs")


def requested_modes(cfg: ScaffoldConfig):
    """(prechain, runs_only) as the knobs ask for them; the mapper turns
    them on when its gates hold as well (a chain module, at most
    CHAIN_MAX_CONTIGS contigs)."""
    prechain = not (cfg.repeats or cfg.sensitive or cfg.x != 0)
    return prechain, prechain and not (cfg.verbose or cfg.paf)


def ensure_contig_sketch_tsv(cfg: ScaffoldConfig, k: int, w: int,
                             device=None) -> str:
    """Sketch the target assembly on the device to the reference's TSV
    artifact (``ntlink_tpu.pipeline.ensure_contig_sketch_tsv``, :42-57);
    a fresh, non-empty TSV is reused. backend=hybrid shares the stream
    with the host's C sketcher; auto and jax sketch on the card alone."""
    global last_sketcher
    out = f"{cfg.target}.k{k}.w{w}.tsv"
    if _is_fresh(out, cfg.target) and os.path.getsize(out) > 0:
        log("Reusing sketch", out)
        return out
    log("Sketching", cfg.target, f"(k={k}, w={w})")
    if cfg.backend == "hybrid":
        last_sketcher = TorchHybridSketcher(device, threads=cfg.t,
                                            host_frac=cfg.hybrid_host_frac)
    else:
        last_sketcher = TorchSketcher(device)
    sketch_fasta_to_tsv(cfg.target, out, k, w, backend=last_sketcher)
    return out


def hybrid_mapper(cfg: ScaffoldConfig, mapper: TorchMapper, index,
                  contig_lengths) -> HybridMapper:
    """The TorchMapper and a HostMapper of the same payload kind behind one
    HybridMapper, as ``ntlink_tpu.pipeline.map_reads`` builds it for
    backend=hybrid (:412-436)."""
    host = HostMapper(
        index, cfg.k, cfg.w, threads=max(1, cfg.t),
        prechain=(_prechain_args(cfg, index, contig_lengths)
                  if mapper.prechained else None),
        runs_only=mapper.runs_only,
    )
    return HybridMapper(mapper, host, cfg.hybrid_host_frac)


def pair_stage(cfg: ScaffoldConfig, device=None) -> str:
    """Mapping + scaffold-graph stage. Returns the DOT artifact path."""
    global last_mapper, last_hybrid, last_map_seconds
    check_supported(cfg)
    prefix = cfg.resolved_prefix()
    dot_path = f"{prefix}.n{cfg.n}.scaffold.dot"
    checkpoint = f"{prefix}.verbose_mapping.tsv"

    wanted = [dot_path]
    if cfg.paf:
        wanted.append(f"{prefix}.paf")
    if cfg.pairs_tsv:
        wanted.append(f"{prefix}.pairs.tsv")
    if all(_is_fresh(p, cfg.target, *cfg.reads) for p in wanted):
        log("Reusing scaffold graph", dot_path)
        return dot_path

    contig_lengths = read_scaffold_lengths(cfg.target)
    explicit = cfg.checkpoint
    if explicit or (
        os.path.exists(checkpoint)
        and _is_fresh(checkpoint, cfg.target, *cfg.reads)
    ):
        ckpt = explicit or checkpoint
        log("Found mapping checkpoint", ckpt, "- bypassing read mapping")
        tally = tally_from_checkpoint(ckpt, contig_lengths, cfg.k, cfg.f)
    else:
        tsv = ensure_contig_sketch_tsv(cfg, cfg.k, cfg.w, device=device)
        log("Loading contig index", tsv)
        index = ContigIndex.from_tsv(tsv)
        log("Index size:", len(index))
        mapper = last_mapper = TorchMapper(
            index, cfg.k, cfg.w, batch_bases=cfg.batch_bases, device=device,
            prechain=_prechain_args(cfg, index, contig_lengths),
            runs_only=not (cfg.verbose or cfg.paf), with_hashes=cfg.repeats,
        )
        last_hybrid = None
        # map_reads wraps a mapper for backend=hybrid only when the C
        # chainer is built; it takes this one as it is
        if cfg.backend == "hybrid" and chain_module() is not None:
            mapper = last_hybrid = hybrid_mapper(cfg, mapper, index,
                                                 contig_lengths)
        t0 = time.perf_counter()
        tally = map_reads(
            cfg, index, contig_lengths,
            verbose_path=checkpoint if cfg.verbose else None,
            paf_path=f"{prefix}.paf" if cfg.paf else None,
            mapper=mapper,
        )
        last_map_seconds = time.perf_counter() - t0
        if last_hybrid is not None:
            log(f"Hybrid split: {last_hybrid.device_reads} reads on the "
                f"device path, {last_hybrid.host_reads} on the host path")

    tally.filter_distances()
    tally.filter_weak_anchors(cfg.a)
    if cfg.pairs_tsv:
        tally.write_pairs_tsv(f"{prefix}.pairs.tsv")
    graph = graph_from_tally(tally, contig_lengths)
    graph = graph.filtered_by_weight(int(cfg.n))
    write_dot(graph, dot_path, largest_ntlink_id(contig_lengths.keys()))
    log("Wrote scaffold graph", dot_path)
    return dot_path


def scaffold_stage(cfg: ScaffoldConfig, device=None) -> str:
    """Full scaffold flow: pair -> layout/stitch -> [overlap trim] -> merge.
    Returns the final scaffolds FASTA path (``ntlink_tpu.pipeline``
    :624-667)."""
    from ntlink_tpu.merge import merge_contigs

    prefix = cfg.resolved_prefix()
    dot_path = pair_stage(cfg, device=device)
    stitch_path = layout_and_stitch(cfg, dot_path)

    merged = f"{cfg.target}.k{cfg.k}.w{cfg.w}.z{cfg.z}.stitch.abyss-scaffold.fa"
    if cfg.overlap:
        from ntlink_tpu.overlap import overlap_stage

        trimmed_fa = f"{prefix}.trimmed_scafs.fa"
        trimmed_path = f"{prefix}.trimmed_scafs.path"
        if _is_fresh(trimmed_fa, stitch_path, dot_path, cfg.target) and \
                _is_fresh(trimmed_path, stitch_path):
            log("Reusing trimmed scaffolds", trimmed_fa)
        else:
            trimmed_fa = overlap_stage(cfg, dot_path, stitch_path)
        if _is_fresh(merged, trimmed_fa, trimmed_path):
            log("Reusing merged scaffolds", merged)
        else:
            merge_contigs(trimmed_fa, trimmed_path, merged)
    elif _is_fresh(merged, cfg.target, stitch_path):
        log("Reusing merged scaffolds", merged)
    else:
        merge_contigs(cfg.target, stitch_path, merged)
    log("Merged scaffolds at", merged)

    final = cfg.out_scaffolds()
    _relink(final, os.path.basename(merged))
    log("Done! Final post-ntLink scaffolds in:", final)
    return final


def run_scaffold(cfg: ScaffoldConfig, gap_fill: bool = False,
                 device=None) -> str:
    """`scaffold [gap_fill]` entry point (``ntlink_tpu.pipeline``
    :684-695)."""
    final = scaffold_stage(cfg, device=device)
    if gap_fill:
        if not cfg.overlap:
            raise ValueError("gap_fill requires the overlap trim stage")
        final = gap_fill_stage(cfg)
    return final


def run_rounds(cfg: ScaffoldConfig, rounds: int, gap_fill: bool = False,
               device=None) -> str:
    """Iterative rounds with AGP mapping liftover (``ntlink_tpu.pipeline``
    :726-781). From round 2 onward the previous round's mapping, lifted to
    the new coordinates, is the pair stage's checkpoint: no contig sketch
    and no read mapping run there (`round_launches` counts each round's
    sketch kernel launches)."""
    from ntlink_tpu.liftover import liftover_mappings

    if cfg.prefix is not None:
        raise ValueError("prefix must be left default when running rounds")
    kwz = f"k{cfg.k}.w{cfg.w}.z{cfg.z}"
    suffix = "ntLink.gap_fill" if gap_fill else "ntLink"
    round_launches.clear()

    target = cfg.target
    round_out = None
    for rnd in range(1, rounds + 1):
        launches0 = sketch_cuda.launches
        round_cfg = dataclasses.replace(cfg, target=target, prefix=None)
        log(f"=== ntLink round {rnd}/{rounds} (target={target})")
        if rnd > 1:
            # liftover previous round's mappings into the new coordinates
            prev_agp = f"{round_out}.agp"
            prev_verbose = f"{round_out}.verbose_mapping.tsv"
            checkpoint = f"{target}.{kwz}.verbose_mapping.tsv"
            liftover_mappings(prev_verbose, prev_agp, checkpoint, cfg.k)
        run_scaffold(round_cfg, gap_fill=gap_fill, device=device)

        prefix = round_cfg.resolved_prefix()
        if rnd == 1:
            round_out = f"{target}.{kwz}.{suffix}.fa"
        else:
            # reference stem rules: %.ntLink[.gap_fill].fa from %[.gap_fill].fa
            stem_suffix = ".gap_fill.fa" if gap_fill else ".fa"
            round_out = f"{target[: -len(stem_suffix)]}.{suffix}.fa"
        if gap_fill:
            produced = f"{target}.{kwz}.ntLink.scaffolds.gap_fill.fa"
            _relink(round_out, produced)
            _relink(f"{round_out}.agp", f"{produced}.agp")
        else:
            produced = f"{target}.{kwz}.ntLink.scaffolds.fa"
            _relink(round_out, os.readlink(produced))
            _relink(f"{round_out}.agp", f"{prefix}.trimmed_scafs.agp")
        _relink(
            f"{round_out}.verbose_mapping.tsv", f"{prefix}.verbose_mapping.tsv"
        )
        clean_artifacts(round_cfg, extra=True)
        target = round_out
        round_launches.append(sketch_cuda.launches - launches0)
        log(f"round {rnd}: {round_launches[-1]} sketch kernel launch(es)")

    final = f"{cfg.target}.{kwz}.{suffix}.{rounds}rounds.fa"
    _relink(final, round_out)
    if gap_fill:
        # reference also links the plain-named rounds alias (ntLink_rounds:91-94)
        _relink(f"{cfg.target}.{kwz}.ntLink.{rounds}rounds.fa", final)
    log("Done ntLink rounds! Final scaffolds in:", final)
    return final
