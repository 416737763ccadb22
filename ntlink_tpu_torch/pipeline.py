"""The `pair` stage driven through the PyTorch sketcher and mapper.

Counterpart of ``ntlink_tpu/pipeline.py::pair_stage`` (:492-589) on one
device. It writes the same artifacts under the same names
(``<target>.k<k>.w<w>.tsv``, ``<prefix>.n<n>.scaffold.dot``,
``.verbose_mapping.tsv``, ``.pairs.tsv``, ``.paf``) and reuses the JAX
package's host stages as they are: the TSV writer, the contig index,
`map_reads` with its C chaining and rendering, the pair tally and the graph
writer. The device work is the port's: the contig sketch
(`sketch.TorchSketcher`) and the read mapper (`device_map.TorchMapper`),
which chains on the device and ships O(runs) payloads under the same gates
as ``DeviceMapper`` (`_prechain_args`; runs only without verbose or PAF
output).
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
    _prechain_args,
    log,
    map_reads,
    read_scaffold_lengths,
)
from ntlink_tpu.sketch import sketch_fasta_to_tsv

from .device_map import TorchMapper
from .sketch import TorchSketcher


#: the TorchMapper of the latest `pair_stage` that mapped reads, and the
#: TorchSketcher of the latest contig sketch, for callers of the CLI that
#: read their counts (`host_fallbacks`, `device_reads` / `device_rows`,
#: `batches_by_pad`, `stream_seconds`, ...)
last_mapper = None
last_sketcher = None


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
    a fresh, non-empty TSV is reused."""
    global last_sketcher
    out = f"{cfg.target}.k{k}.w{w}.tsv"
    if _is_fresh(out, cfg.target) and os.path.getsize(out) > 0:
        log("Reusing sketch", out)
        return out
    log("Sketching", cfg.target, f"(k={k}, w={w})")
    last_sketcher = TorchSketcher(device)
    sketch_fasta_to_tsv(cfg.target, out, k, w, backend=last_sketcher)
    return out


def pair_stage(cfg: ScaffoldConfig, device=None) -> str:
    """Mapping + scaffold-graph stage. Returns the DOT artifact path."""
    global last_mapper
    check_supported(cfg)
    # map_reads' own mapper choice is bypassed (the mapper is passed in);
    # backend=numpy keeps it from the hybrid split
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
        tsv = ensure_contig_sketch_tsv(cfg, cfg.k, cfg.w, device=device)
        log("Loading contig index", tsv)
        index = ContigIndex.from_tsv(tsv)
        log("Index size:", len(index))
        mapper = TorchMapper(
            index, cfg.k, cfg.w, batch_bases=cfg.batch_bases, device=device,
            prechain=_prechain_args(cfg, index, contig_lengths),
            runs_only=not (cfg.verbose or cfg.paf),
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
