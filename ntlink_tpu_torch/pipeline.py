"""The `pair` stage driven through the PyTorch mapper.

Counterpart of ``ntlink_tpu/pipeline.py::pair_stage`` (:492-589). It writes
the same artifacts under the same names (``<prefix>.n<n>.scaffold.dot``,
``.verbose_mapping.tsv``, ``.pairs.tsv``, ``.paf``) and reuses the JAX
package's host stages as they are: the native C contig sketch, the contig
index, `map_reads` with its C chaining and rendering, the pair tally and the
graph writer. Only the read mapper differs: `device_map.TorchMapper`.
"""
from __future__ import annotations

import dataclasses
import os

from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu.graphio import graph_from_tally, largest_ntlink_id, write_dot
from ntlink_tpu.index import ContigIndex
from ntlink_tpu.pairs import tally_from_checkpoint
from ntlink_tpu.pipeline import (
    _is_fresh,
    ensure_contig_sketch_tsv,
    log,
    map_reads,
    read_scaffold_lengths,
)

from .device_map import TorchMapper


#: the TorchMapper of the latest `pair_stage` that mapped reads, for callers
#: of the CLI that read its counts (`host_fallbacks`, `device_reads`,
#: `batches_by_pad`, `stream_seconds`)
last_mapper = None


class NotPorted(ValueError):
    """A configuration the port does not run yet."""


def check_supported(cfg: ScaffoldConfig) -> None:
    """Raise NotPorted for settings whose device path is not ported."""
    if cfg.repeats:
        raise NotPorted("not yet ported: repeats=True (hash planes)")
    if cfg.backend != "auto":
        raise NotPorted(f"not yet ported: backend={cfg.backend}")
    if cfg.index_sharding != "replicated":
        raise NotPorted(f"not yet ported: index_sharding={cfg.index_sharding}")
    if int(os.environ.get("NTLINK_NUM_PROCESSES", "0") or 0) > 1:
        raise NotPorted("not yet ported: multi-process runs")


def pair_stage(cfg: ScaffoldConfig, device=None) -> str:
    """Mapping + scaffold-graph stage. Returns the DOT artifact path."""
    global last_mapper
    check_supported(cfg)
    # host stages run exactly as ntlink_tpu's backend=numpy path: the
    # contig sketch is the native C sketcher, never the JAX one
    host_cfg = dataclasses.replace(cfg, backend="numpy")
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
        tsv = ensure_contig_sketch_tsv(host_cfg, cfg.k, cfg.w)
        log("Loading contig index", tsv)
        index = ContigIndex.from_tsv(tsv)
        log("Index size:", len(index))
        mapper = TorchMapper(
            index, cfg.k, cfg.w, batch_bases=cfg.batch_bases, device=device
        )
        last_mapper = mapper
        tally = map_reads(
            host_cfg, index, contig_lengths,
            verbose_path=checkpoint if cfg.verbose else None,
            paf_path=f"{prefix}.paf" if cfg.paf else None,
            mapper=mapper,
        )

    tally.filter_distances()
    tally.filter_weak_anchors(cfg.a)
    if cfg.pairs_tsv:
        tally.write_pairs_tsv(f"{prefix}.pairs.tsv")
    graph = graph_from_tally(tally, contig_lengths)
    graph = graph.filtered_by_weight(int(cfg.n))
    write_dot(graph, dot_path, largest_ntlink_id(contig_lengths.keys()))
    log("Wrote scaffold graph", dot_path)
    return dot_path
