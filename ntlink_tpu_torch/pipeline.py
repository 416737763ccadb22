"""The stages of ntlink_tpu driven through the PyTorch sketcher and mapper.

Counterpart of ``ntlink_tpu/pipeline.py``. `pair_stage`
(:492-589) writes the same artifacts under the same names
(``<target>.k<k>.w<w>.tsv``, ``<prefix>.n<n>.scaffold.dot``,
``.verbose_mapping.tsv``, ``.pairs.tsv``, ``.paf``) through the port's own
copies of the host stages: the TSV writer, the contig index, `map_reads`
with its C chaining and rendering, the pair tally and the graph writer.
The device work is the contig sketch
(`sketch.get_backend`: `sketch.TorchSketcher`, or with backend=hybrid, and
with auto at t > 1, `sketch.TorchHybridSketcher`, which shares the stream
with the host's C path) and the read mapper (`device_map.TorchMapper`),
which chains on the device and ships O(runs) payloads under the same gates
as ``DeviceMapper`` (`_prechain_args`; runs only without verbose or PAF
output). With backend=hybrid the read stream splits with the host's C path
too (``hybrid_map.HybridMapper``).
backend=numpy is the caller asking for the host by name: contig sketch and
read mapping run on the host (`HostMapper`, chaining on the consumer
thread) and no device is resolved or touched. `device` may be a sequence
of devices: the mapper splits its batches over them (index replicated, or
hash-sharded with index_sharding=hash) and the contig sketcher uses the
first. With NTLINK_NUM_PROCESSES > 1 (`parallel.distributed`) every
process sketches the contigs and maps its share of the read files, and the
per-file tallies and artifact parts merge in global file order.

`scaffold_stage`, `run_scaffold` and `run_rounds` (:624-781) are the
reference's flows around the port's `pair_stage`, with the same file names
and symlinks; layout, stitch, overlap trim, merge, gap-fill, liftover and
clean-up are host code (`layout.py`, `stitch.py`, `overlap.py`, `merge.py`,
`gapfill.py`, `liftover.py`, each the counterpart of the module of the same
name in ``ntlink_tpu``). Nothing here imports ``ntlink_tpu``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from . import device as device_mod
from .config import ScaffoldConfig
from .device_map import TorchMapper
from .graphio import graph_from_tally, largest_ntlink_id, read_dot, write_dot
from .host_map import HostMapper
from .hybrid_map import HybridMapper
from .index import ContigIndex
from .mapping import AnchorHit as AH, RunView, chain_read_hits
from .native import chain_module
from .ops import nthash_np, sketch_cuda
from .paf import paf_lines
from .parallel.distributed import (
    all_gather_file_tallies, maybe_init_distributed, merge_file_parts,
)
from .pairs import PairTally, tally_from_checkpoint
from .seqio import stream_fastx
from .seqio.fastx import prefetch_files, stream_code_blocks, stream_codes
from .sketch import get_backend, sketch_fasta_to_tsv
from .stream_pipeline import PhaseTimer
from .tracing import GLOBAL as tracer

BACKENDS = ("auto", "jax", "hybrid", "numpy")

#: the TorchMapper of the latest `pair_stage` that mapped reads (None with
#: backend=numpy), the HybridMapper around it (backend=hybrid, else None),
#: and the sketcher of the latest contig sketch (TorchSketcher, or
#: TorchHybridSketcher; None with backend=numpy), for
#: callers of the CLI that read their counts (`host_fallbacks`,
#: `device_reads` / `host_reads`, `batches_by_pad`, `stream_seconds`, ...)
last_mapper = None
last_hybrid = None
last_sketcher = None
#: wall seconds of the latest `pair_stage`'s read mapping (`map_reads`)
last_map_seconds = 0.0
#: wall seconds of the latest `pair_stage`'s contig index parse
#: (`ContigIndex.from_tsv`)
last_index_seconds = 0.0
#: sketch kernel launches of each round of the latest `run_rounds`
round_launches: List[int] = []


def log(*parts) -> None:
    print(time.strftime("%Y-%m-%d %H:%M:%S"), "-", *parts, file=sys.stdout, flush=True)


def _is_fresh(output: str, *inputs: str) -> bool:
    """True if `output` exists and is newer than every input (Make semantics)."""
    if not os.path.exists(output):
        return False
    out_mtime = os.path.getmtime(output)
    return all(
        os.path.exists(i) and os.path.getmtime(i) <= out_mtime for i in inputs
    )


def _relink(link: str, target: str) -> None:
    if os.path.islink(link) or os.path.exists(link):
        os.unlink(link)
    os.symlink(target, link)


def read_scaffold_lengths(path: str) -> Dict[str, int]:
    return {rec.name: len(rec.seq) for rec in stream_fastx(path)}


def check_supported(cfg: ScaffoldConfig) -> None:
    """Raise ValueError for a backend name the reference does not know;
    every other setting of ``ntlink_tpu`` runs."""
    if cfg.backend not in BACKENDS:
        raise ValueError(f"unknown backend={cfg.backend}")


def split_devices(cfg: ScaffoldConfig, device):
    """(the contig sketcher's device, the mapper's `devices` or None) for
    the `device` argument of the flows: None (the card, and every visible
    card for the mapper), one device, or a sequence of devices.
    backend=numpy takes no device: `device` must be None or
    `device.HOST_ONLY`, and both come back as HOST_ONLY."""
    if cfg.backend == "numpy":
        if device not in (None, device_mod.HOST_ONLY):
            raise ValueError(
                f"backend=numpy runs on the host and takes no device, got "
                f"{device!r}"
            )
        return device_mod.HOST_ONLY, device_mod.HOST_ONLY
    if device == device_mod.HOST_ONLY:
        raise ValueError(f"backend={cfg.backend} needs a device")
    if isinstance(device, (list, tuple)):
        return device[0], list(device)
    return device, None if device is None else [device]


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
    a fresh, non-empty TSV is reused. The sketcher is `sketch.get_backend`'s
    for cfg.backend and cfg.t: backend=hybrid, and auto with t > 1, share
    the stream between the card and the host's C sketcher (adaptively:
    hybrid_host_frac pins the read mapping's share only); jax, and auto
    with t=1, sketch on the card alone; numpy (`device` is HOST_ONLY)
    sketches on the host's cfg.t threads."""
    global last_sketcher
    out = f"{cfg.target}.k{k}.w{w}.tsv"
    if _is_fresh(out, cfg.target) and os.path.getsize(out) > 0:
        log("Reusing sketch", out)
        return out
    log("Sketching", cfg.target, f"(k={k}, w={w})")
    last_sketcher = get_backend(cfg.backend, threads=cfg.t, device=device)
    sketch_fasta_to_tsv(cfg.target, out, k, w, backend=last_sketcher,
                        threads=cfg.t)
    return out


def _prechain_args(cfg: ScaffoldConfig, index: ContigIndex, contig_lengths):
    """(clen int32 in contig-id order, z) when the run qualifies for
    pre-chained payloads (chaining acceptance applied inside the mappers:
    on-device for TorchMapper, in C workers for HostMapper), else None.
    Gated to the default knobs: the repeat filter must run BEFORE
    chaining (host path), sensitive-mode subsume and the x fudge factor
    are host-only (x uses double math whose float semantics the device
    does not replicate bit-exactly)."""
    if (
        contig_lengths is None
        or cfg.repeats
        or cfg.sensitive
        or cfg.x != 0
    ):
        return None
    clen = np.zeros(len(index.contig_names), dtype=np.int32)
    for i, nme in enumerate(index.contig_names):
        clen[i] = contig_lengths[nme]
    return clen, cfg.z


def _make_native_chainer(mapper, contig_lengths):
    """Native per-read chaining + verbose rendering (None if unavailable)."""
    chain_mod = chain_module()
    if chain_mod is None:
        return None
    clen = np.zeros(len(mapper.contig_names), dtype=np.int32)
    for name, idx in mapper._contig_order.items():
        clen[idx] = contig_lengths[name]
    return chain_mod.Chainer(clen, mapper.contig_names)


def _write_verbose(fh, name, runs) -> None:
    for run in runs:
        fh.write(
            f"{name}\t{run.contig}\t{run.hit_count}\t{run.hits_string()}\n".encode()
        )


# reads per native chain_batch call: one C crossing + one verbose write per
# group instead of per read. Sized to roughly one device batch so the C
# chaining + tally of batch N overlap the wire/device time of batches N+1..
# (map_stream_raw yields each read as soon as its batch drains); still large
# enough that the per-call overhead is negligible (~1k reads x ~150 anchors
# x 16 B ~= 2.5 MB per call)
CHAIN_GROUP = 1024


def _repeat_filter_batch(offs, arrays, hi, lo):
    """Vectorized per-read repeat filter: drop every anchor whose 64-bit
    hash occurs more than once within its read's matched anchors
    (reference ntlink_pair.py:368-374). Returns (new_offs, new_arrays)."""
    total = int(offs[-1])
    n_g = len(offs) - 1
    rid = np.repeat(np.arange(n_g, dtype=np.int64), np.diff(offs))
    order = np.lexsort((lo, hi, rid))
    sh, sl, sr = hi[order], lo[order], rid[order]
    same_prev = np.zeros(total, bool)
    same_prev[1:] = (sr[1:] == sr[:-1]) & (sh[1:] == sh[:-1]) & (
        sl[1:] == sl[:-1]
    )
    dup_sorted = same_prev.copy()
    dup_sorted[:-1] |= same_prev[1:]
    keep = np.empty(total, bool)
    keep[order] = ~dup_sorted
    new_offs = np.zeros(n_g + 1, np.int64)
    np.cumsum(np.bincount(rid[keep], minlength=n_g), out=new_offs[1:])
    return new_offs, [a[keep] for a in arrays]


def _file_codes(cfg, mapper):
    """(reads file, the ``PhaseTimer`` of its stream, its codes) per read
    file, in order, up to cfg.t files parsing at once on background
    threads (pigz-equivalent; file order preserved for the order-sensitive
    verbose/tally artifacts). A TorchMapper's stream takes the codes in
    blocks of `TorchMapper.BLOCK_BASES` bases (`stream_code_blocks`), any
    other mapper's (`HostMapper`, `HybridMapper`) as (name, codes)
    pairs. The timers are on with NTLINK_TIMING=1, read once; the parser
    threads key their parse in them too."""
    timers = [PhaseTimer.from_env() for _ in cfg.reads]
    reader_timers = timers if timers and timers[0].on else None
    if isinstance(mapper, TorchMapper):
        def make_iter(path):
            return stream_code_blocks(path, mapper.BLOCK_BASES)
        depth = mapper.blocks_ahead
    else:
        make_iter, depth = stream_codes, 256
    for (reads_file, codes), timer in zip(prefetch_files(
        cfg.reads, make_iter, threads=cfg.t, depth=depth,
        timers=reader_timers
    ), timers):
        yield reads_file, timer, codes


def _held_stream(mapper, timer: PhaseTimer):
    """`mapper.hold_stream(timer)` for a TorchMapper: its read stream then
    takes `timer`, in which the consumer keys its own work, and its wall
    and timing end with the block, the consumer's last group included.
    Another mapper's stream accounts for itself."""
    if isinstance(mapper, TorchMapper):
        return mapper.hold_stream(timer)
    return contextlib.nullcontext()


def _map_reads_native(cfg, mapper, chainer, tally, contig_lengths, verbose_fh,
                      paf_fh):
    """Hot loop: device batches + one C chain_batch call per read group.

    Zero per-anchor Python anywhere; per-read Python is one list append.
    Only reads producing >= 2 accepted runs surface as Python objects (the
    pair tally is a no-op below that; reference ntlink_pair.py:416-435).
    Verbose/PAF rendering and the repeat filter all run batch-level (C /
    NumPy), so paf=True and repeats=True stay on this path. With
    NTLINK_TIMING=1 each group is keyed in the stream's timer as
    group_gather, chain_render, verbose_write and tally. While the Tracer
    is on, the anchors and bytes of each stream's verbose lines go to it as
    one ``render/verbose`` count, taken before the stream's summary line.
    """
    names = mapper.contig_names
    n_reads = 0
    g_names: list = []
    g_lens: list = []
    g_raw: list = []
    mode = (1 if verbose_fh else 0) | (2 if paf_fh else 0)
    rendered = ({"anchors": 0, "bytes": 0}
                if tracer.enabled and verbose_fh else None)

    def flush_group(timer: PhaseTimer) -> None:
        if not g_names:
            return
        with timer.span("group_gather"):
            n_g = len(g_names)
            offs = np.zeros(n_g + 1, np.int64)
            for i, raw in enumerate(g_raw):
                offs[i + 1] = offs[i] + (raw[0] if raw is not None else 0)
            total = int(offs[-1])
            cid = np.empty(total, np.int32)
            cpos = np.empty(total, np.int32)
            rpos = np.empty(total, np.int32)
            sbits = np.empty(total, np.int32)
            if cfg.repeats:
                hi = np.empty(total, np.int32)
                lo = np.empty(total, np.int32)
            for i, raw in enumerate(g_raw):
                if raw is None:
                    continue
                o, n = int(offs[i]), raw[0]
                rpos[o : o + n] = raw[1]
                cid[o : o + n] = raw[2]
                cpos[o : o + n] = raw[3]
                sbits[o : o + n] = raw[4]
                if cfg.repeats:
                    hi[o : o + n] = raw[5]
                    lo[o : o + n] = raw[6]
            if cfg.repeats and total:
                offs, (cid, cpos, rpos, sbits) = _repeat_filter_batch(
                    offs, (cid, cpos, rpos, sbits), hi, lo
                )
            rlens = np.asarray(g_lens, np.int32)
        # pre-chained mappers (on-device chaining / chain_select workers)
        # deliver ACCEPTED anchors in final order: chain_batch only groups
        # consecutive cids and renders — no filters re-run
        with timer.span("chain_render"):
            runs_b, ro_b, vbytes, pbytes = chainer.chain_batch(
                np.ascontiguousarray(cid), np.ascontiguousarray(cpos),
                np.ascontiguousarray(rpos), np.ascontiguousarray(sbits),
                offs, rlens,
                g_names if mode else None,
                cfg.k, cfg.z, 1 if cfg.sensitive else 0, float(cfg.x), mode,
                1 if getattr(mapper, "prechained", False) else 0,
            )
        if rendered is not None:
            # every anchor of a run is rendered: the rows' hit counts
            rendered["anchors"] += int(np.frombuffer(runs_b, np.int32)[1::8]
                                       .sum())
            rendered["bytes"] += len(vbytes)
        if (verbose_fh and vbytes) or (paf_fh and pbytes):
            with timer.span("verbose_write"):
                if verbose_fh and vbytes:
                    verbose_fh.write(vbytes)
                if paf_fh and pbytes:
                    paf_fh.write(pbytes)
        with timer.span("tally"):
            runs_arr = np.frombuffer(runs_b, np.int32).reshape(-1, 8)
            ro = np.frombuffer(ro_b, np.int32)
            for i in np.nonzero(np.diff(ro) >= 2)[0]:
                runs = [
                    RunView(
                        names[int(row[0])],
                        int(row[1]),
                        AH(0, int(row[2]), "+" if row[4] & 1 else "-",
                           int(row[3]), "+" if row[4] & 2 else "-"),
                        AH(0, int(row[5]), "+" if row[7] & 1 else "-",
                           int(row[6]), "+" if row[7] & 2 else "-"),
                    )
                    for row in runs_arr[ro[i] : ro[i + 1]]
                ]
                tally.add_read(runs, int(rlens[i]))
        g_names.clear()
        g_lens.clear()
        g_raw.clear()

    for reads_file, timer, codes in _file_codes(cfg, mapper):
        log("Mapping reads", reads_file, "(native batch chain)")
        with _held_stream(mapper, timer):
            for name, read_len, raw in mapper.map_stream_raw(codes):
                n_reads += 1
                g_names.append(name)
                g_lens.append(read_len)
                g_raw.append(raw)
                if len(g_names) >= CHAIN_GROUP:
                    flush_group(timer)
            flush_group(timer)
            if rendered is not None:
                tracer.count("render/verbose", **rendered)
                rendered.update(anchors=0, bytes=0)
    return n_reads


def _map_reads_runs(cfg, mapper, tally):
    """Runs-only hot loop: the mappers ship per-run summary rows [cid,
    count, f_cpos, f_rpos, f_sbits, l_cpos, l_rpos, l_sbits] (chaining
    already applied on-device / in C workers), so the consumer does no
    chaining at all — single-run reads are a pure counter bump and only
    multi-run reads build Python objects (the pair tally is a no-op below
    2 runs; reference ntlink_pair.py:416-435). No verbose/PAF here: those
    need per-anchor payloads (map_reads gates). With NTLINK_TIMING=1 each
    multi-run read's tally is keyed in the stream's timer as tally."""
    names = mapper.contig_names
    n_reads = 0
    for reads_file, timer, codes in _file_codes(cfg, mapper):
        log("Mapping reads", reads_file, "(runs-only payload)")
        timing = timer.on
        with _held_stream(mapper, timer):
            for name, read_len, raw in mapper.map_stream_raw(codes):
                n_reads += 1
                if raw is None or raw[0] < 2:
                    continue
                if timing:
                    t0 = time.perf_counter()
                runs = [
                    RunView(
                        names[r0],
                        r1,
                        AH(0, r2, "+" if r4 & 1 else "-",
                           r3, "+" if r4 & 2 else "-"),
                        AH(0, r5, "+" if r7 & 1 else "-",
                           r6, "+" if r7 & 2 else "-"),
                    )
                    for r0, r1, r2, r3, r4, r5, r6, r7 in raw[1].tolist()
                ]
                tally.add_read(runs, read_len)
                if timing:
                    timer.add("tally", time.perf_counter() - t0)
    return n_reads


def _host_hit_stream_codes(cfg, index, codes_iter):
    """NumPy-backend per-read anchor stream (sketch + dict join on host)."""
    for name, codes in codes_iter:
        mins = nthash_np.sketch_codes(codes, cfg.k, cfg.w)
        mask = index.member_mask(mins.hashes)
        if not mask.any():
            yield name, len(codes), []
            continue
        hits = []
        for h, p, f in zip(
            mins.hashes[mask], mins.positions[mask], mins.forward[mask]
        ):
            entry = index.get(int(h))
            hits.append((
                entry.contig,
                AH(int(h), entry.position, entry.strand, int(p),
                   "+" if f else "-"),
            ))
        yield name, len(codes), hits


def _map_reads_generic(cfg, mapper, index, tally, contig_lengths,
                       verbose_fh, paf_fh):
    """General path: per-hit Python objects, taken only when the C chainer
    did not build (`mapper` None: the NumPy sketch and dict join)."""
    n_reads = 0
    for reads_file, codes_iter in prefetch_files(
        cfg.reads, stream_codes, threads=cfg.t
    ):
        log("Mapping reads", reads_file)
        if mapper is not None:
            hit_stream = mapper.map_stream(codes_iter)
        else:
            hit_stream = _host_hit_stream_codes(cfg, index, codes_iter)
        for name, read_len, hits in hit_stream:
            n_reads += 1
            if not hits:
                continue
            if cfg.repeats:
                # drop every occurrence of a hash matched more than once
                # within this read (reference ntlink_pair.py:368-374)
                counts: Dict[int, int] = {}
                for _, h in hits:
                    counts[h.mx] = counts.get(h.mx, 0) + 1
                hits = [(c, h) for c, h in hits if counts[h.mx] == 1]
            if not hits:
                continue
            runs = chain_read_hits(
                hits, read_len, contig_lengths, cfg.k, cfg.z,
                x=cfg.x, sensitive=cfg.sensitive,
            )
            if not runs:
                continue
            if verbose_fh:
                _write_verbose(verbose_fh, name, runs)
            if paf_fh:
                for line in paf_lines(runs, name, read_len, contig_lengths, cfg.k):
                    paf_fh.write((line + "\n").encode())
            tally.add_read(runs, read_len)
    return n_reads


def map_reads(
    cfg: ScaffoldConfig,
    index: ContigIndex,
    contig_lengths: Dict[str, int],
    verbose_path: Optional[str],
    paf_path: Optional[str],
    mapper,
    tally: Optional[PairTally] = None,
) -> PairTally:
    """Stream read files through sketch -> match -> chain -> tally
    (``ntlink_tpu.pipeline.map_reads``, :369-489, for a mapper the caller
    built: a TorchMapper, the HybridMapper around one, or with
    backend=numpy a HostMapper; None only when the C chainer did not build
    there). Pass `tally`/`mapper` again to accumulate across calls (the
    per-file sharding of multi-process runs) without rebuilding the index
    on the device.

    Chaining and verbose/PAF rendering run in native C and the repeat
    filter vectorized in NumPy; only a failed C build takes the general
    object path. All paths keep the reference's exact order-sensitive
    semantics."""
    if tally is None:
        tally = PairTally(contig_lengths, cfg.k, cfg.f)
    # crash safety: stream into .tmp and rename only on success, so a
    # killed run can never leave a truncated verbose_mapping.tsv behind,
    # which a rerun would trust as a complete mapping checkpoint
    verbose_tmp = f"{verbose_path}.tmp" if verbose_path else None
    paf_tmp = f"{paf_path}.tmp" if paf_path else None
    verbose_fh = open(verbose_tmp, "wb") if verbose_path else None
    paf_fh = open(paf_tmp, "wb") if paf_path else None
    chainer = (None if mapper is None
               else _make_native_chainer(mapper, contig_lengths))

    try:
        if getattr(mapper, "runs_only", False):
            # O(runs) payloads carry no per-anchor data, so they cannot
            # render verbose/PAF artifacts (`pair_stage` only builds
            # runs-only mappers when neither is requested)
            if verbose_fh or paf_fh:
                raise ValueError(
                    "runs_only mapper cannot render verbose/PAF artifacts"
                )
            n_reads = _map_reads_runs(cfg, mapper, tally)
        elif chainer is not None:
            n_reads = _map_reads_native(
                cfg, mapper, chainer, tally, contig_lengths, verbose_fh,
                paf_fh
            )
        else:
            n_reads = _map_reads_generic(
                cfg, mapper, index, tally, contig_lengths, verbose_fh,
                paf_fh
            )
    except Exception:
        # mirror the reference's partial-output cleanup (ntlink_pair.py:608-613)
        for fh, path in ((verbose_fh, verbose_tmp), (paf_fh, paf_tmp)):
            if fh:
                fh.close()
                os.unlink(path)
        raise
    finally:
        for fh in (verbose_fh, paf_fh):
            if fh and not fh.closed:
                fh.close()
    if verbose_path:
        os.replace(verbose_tmp, verbose_path)
    if paf_path:
        os.replace(paf_tmp, paf_path)
    log("Mapped", n_reads, "reads")
    return tally


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


def make_mapper(cfg: ScaffoldConfig, index: ContigIndex, contig_lengths,
                devices):
    """The read mapper of a `pair_stage` (``_make_device_mapper`` and the
    mapper choice of ``map_reads``, ntlink_tpu/pipeline.py:112-130,
    :409-452); sets `last_mapper` and `last_hybrid`."""
    global last_mapper, last_hybrid
    last_mapper = last_hybrid = None
    if cfg.backend == "numpy":
        # host only: chaining stays on the consumer thread (chain_batch),
        # where it overlaps the workers' sketching
        host = HostMapper(index, cfg.k, cfg.w, threads=cfg.t)
        return host if chain_module() is not None else None
    mapper = last_mapper = TorchMapper(
        index, cfg.k, cfg.w, batch_bases=cfg.batch_bases, devices=devices,
        prechain=_prechain_args(cfg, index, contig_lengths),
        runs_only=not (cfg.verbose or cfg.paf), with_hashes=cfg.repeats,
        index_sharding=cfg.index_sharding, idx_shards=cfg.idx_shards,
    )
    # the hybrid stream needs the C chainer (its host leg and the
    # consumer both chain there)
    if cfg.backend == "hybrid" and chain_module() is not None:
        mapper = last_hybrid = hybrid_mapper(cfg, mapper, index,
                                             contig_lengths)
    return mapper


def _stage_mapper(cfg: ScaffoldConfig, index: ContigIndex, contig_lengths,
                  devices):
    """`make_mapper`, logging the contig table. `pair_stage` calls it
    inside ``pair/map-reads``, where the JAX package builds its mapper
    (inside ``map_reads``), so that the table's spans nest there."""
    mapper = make_mapper(cfg, index, contig_lengths, devices)
    if last_mapper is not None and last_mapper.index_sharding != "hash":
        log(f"Contig table: {last_mapper.didx.layout.describe()} per "
            f"device; built in {last_mapper.build_seconds:.1f} s, uploaded in "
            f"{last_mapper.upload_seconds:.1f} s")
    return mapper


def pair_stage(cfg: ScaffoldConfig, device=None) -> str:
    """Mapping + scaffold-graph stage. Returns the DOT artifact path."""
    global last_map_seconds, last_index_seconds
    check_supported(cfg)
    sketch_device, devices = split_devices(cfg, device)
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
        with tracer.stage("pair/checkpoint-tally"):
            tally = tally_from_checkpoint(ckpt, contig_lengths, cfg.k, cfg.f)
    else:
        process_id, n_processes = maybe_init_distributed()
        with tracer.stage("pair/contig-sketch"):
            tsv = ensure_contig_sketch_tsv(cfg, cfg.k, cfg.w,
                                           device=sketch_device)
            log("Loading contig index", tsv)
            t0 = time.perf_counter()
            index = ContigIndex.from_tsv(tsv)
            last_index_seconds = time.perf_counter() - t0
            log("Index size:", len(index))
        if n_processes > 1:
            # per-read-file sharding: each process maps its files into
            # per-file tallies and artifact parts, then everything merges
            # in global file order, byte-identical to a one-process run
            # (reference contract: one verbose/paf file,
            # ntlink_pair.py:382-388)
            per_file_tallies: Dict[int, PairTally] = {}
            verbose_parts: Dict[int, str] = {}
            paf_parts: Dict[int, str] = {}
            with tracer.stage("pair/map-reads"):
                mapper = _stage_mapper(cfg, index, contig_lengths, devices)
                t0 = time.perf_counter()
                for fi, reads_file in enumerate(cfg.reads):
                    if fi % n_processes != process_id:
                        continue
                    log(f"Host {process_id}/{n_processes} mapping", reads_file)
                    sub = dataclasses.replace(cfg, reads=[reads_file])
                    vp = f"{checkpoint}.part{fi}" if cfg.verbose else None
                    pp = f"{prefix}.paf.part{fi}" if cfg.paf else None
                    per_file_tallies[fi] = map_reads(
                        sub, index, contig_lengths, vp, pp, mapper=mapper
                    )
                    if vp:
                        verbose_parts[fi] = vp
                    if pp:
                        paf_parts[fi] = pp
            last_map_seconds = time.perf_counter() - t0
            with tracer.stage("pair/tally-allgather"):
                tally = all_gather_file_tallies(
                    per_file_tallies, PairTally(contig_lengths, cfg.k, cfg.f)
                )
                if cfg.verbose:
                    merge_file_parts(checkpoint, verbose_parts)
                if cfg.paf:
                    merge_file_parts(f"{prefix}.paf", paf_parts)
        else:
            with tracer.stage("pair/map-reads"):
                mapper = _stage_mapper(cfg, index, contig_lengths, devices)
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

    with tracer.stage("pair/graph-build"):
        tally.filter_distances()
        tally.filter_weak_anchors(cfg.a)
        if cfg.pairs_tsv:
            tally.write_pairs_tsv(f"{prefix}.pairs.tsv")
        graph = graph_from_tally(tally, contig_lengths)
        graph = graph.filtered_by_weight(int(cfg.n))
        write_dot(graph, dot_path, largest_ntlink_id(contig_lengths.keys()))
    log("Wrote scaffold graph", dot_path)
    return dot_path


def layout_and_stitch(cfg: ScaffoldConfig, dot_path: str) -> str:
    """n-sweep layout + optimal-n stitch. Returns the stitch path file."""
    from .layout import run_n_sweep
    from .stitch import stitch

    prefix = cfg.resolved_prefix()
    stitch_path = f"{prefix}.stitch.path"
    if _is_fresh(stitch_path, dot_path, cfg.target):
        log("Reusing stitched paths", stitch_path)
        return stitch_path
    graph = read_dot(dot_path)
    contig_lengths = read_scaffold_lengths(cfg.target)
    log("Layout n-sweep", f"n={cfg.n}..{cfg.max_n}")
    sweep_files = run_n_sweep(
        graph, contig_lengths, cfg.n, cfg.max_n, cfg.z, cfg.g, prefix,
        threads=cfg.t,
    )
    stitch(
        sweep_files,
        graph,
        stitch_path,
        max_gap=cfg.G,
        conservative=cfg.conservative,
    )
    for f in sweep_files:
        os.unlink(f)
        os.unlink(f + ".sterr")
    log("Wrote stitched paths", stitch_path)
    return stitch_path


def scaffold_stage(cfg: ScaffoldConfig, device=None) -> str:
    """Full scaffold flow: pair -> layout/stitch -> [overlap trim] -> merge.
    Returns the final scaffolds FASTA path (``ntlink_tpu.pipeline``
    :624-667)."""
    from .merge import merge_contigs

    prefix = cfg.resolved_prefix()
    dot_path = pair_stage(cfg, device=device)
    with tracer.stage("layout+stitch"):
        stitch_path = layout_and_stitch(cfg, dot_path)

    merged = f"{cfg.target}.k{cfg.k}.w{cfg.w}.z{cfg.z}.stitch.abyss-scaffold.fa"
    if cfg.overlap:
        from .overlap import overlap_stage

        trimmed_fa = f"{prefix}.trimmed_scafs.fa"
        trimmed_path = f"{prefix}.trimmed_scafs.path"
        if _is_fresh(trimmed_fa, stitch_path, dot_path, cfg.target) and \
                _is_fresh(trimmed_path, stitch_path):
            log("Reusing trimmed scaffolds", trimmed_fa)
        else:
            with tracer.stage("overlap-trim"):
                trimmed_fa = overlap_stage(cfg, dot_path, stitch_path)
        if _is_fresh(merged, trimmed_fa, trimmed_path):
            log("Reusing merged scaffolds", merged)
        else:
            with tracer.stage("merge"):
                merge_contigs(trimmed_fa, trimmed_path, merged)
    elif _is_fresh(merged, cfg.target, stitch_path):
        log("Reusing merged scaffolds", merged)
    else:
        with tracer.stage("merge"):
            merge_contigs(cfg.target, stitch_path, merged)
    log("Merged scaffolds at", merged)

    final = cfg.out_scaffolds()
    _relink(final, os.path.basename(merged))
    log("Done! Final post-ntLink scaffolds in:", final)
    return final


def gap_fill_stage(cfg: ScaffoldConfig) -> str:
    """Gap-fill the trimmed layout; re-points the final scaffolds symlink
    at the gap-filled FASTA (reference ntLink:266-271)."""
    from .gapfill import gap_fill_stage as run_gap_fill

    out = run_gap_fill(cfg)
    final = cfg.out_scaffolds()
    _relink(final, os.path.basename(out))
    log("Done! Final post-ntLink and gap-filled scaffolds in:", final)
    return out


def run_scaffold(cfg: ScaffoldConfig, gap_fill: bool = False,
                 device=None) -> str:
    """`scaffold [gap_fill]` entry point (``ntlink_tpu.pipeline``
    :684-695)."""
    final = scaffold_stage(cfg, device=device)
    if gap_fill:
        if not cfg.overlap:
            raise ValueError("gap_fill requires the overlap trim stage")
        with tracer.stage("gap-fill"):
            final = gap_fill_stage(cfg)
    if tracer.enabled:
        tracer.report()
        tracer.write_json(f"{cfg.resolved_prefix()}.trace.json")
    return final


def clean_artifacts(cfg: ScaffoldConfig, extra: bool = False) -> None:
    """Remove intermediate artifacts (reference ntLink clean/extra_clean)."""
    prefix = cfg.resolved_prefix()
    doomed = [f"{cfg.target}.k{cfg.k}.w{cfg.w}.tsv"]
    if cfg.overlap:
        doomed += [
            f"{prefix}.trimmed_scafs.fa",
            f"{prefix}.trimmed_scafs.tsv",
            f"{prefix}.stitch.path",
        ]
    gap_fill_fa = f"{cfg.target}.k{cfg.k}.w{cfg.w}.z{cfg.z}.ntLink.scaffolds.gap_fill.fa"
    if os.path.exists(gap_fill_fa):
        doomed.append(f"{cfg.target}.k{cfg.k}.w{cfg.w}.z{cfg.z}.stitch.abyss-scaffold.fa")
    if extra:
        if cfg.overlap:
            doomed.append(f"{prefix}.trimmed_scafs.path")
        doomed.append(f"{prefix}.n{cfg.n}.scaffold.dot")
    for path in doomed:
        if os.path.exists(path) or os.path.islink(path):
            os.unlink(path)


def run_rounds(cfg: ScaffoldConfig, rounds: int, gap_fill: bool = False,
               device=None) -> str:
    """Iterative rounds with AGP mapping liftover (``ntlink_tpu.pipeline``
    :726-781). From round 2 onward the previous round's mapping, lifted to
    the new coordinates, is the pair stage's checkpoint: no contig sketch
    and no read mapping run there (`round_launches` counts each round's
    sketch kernel launches)."""
    from .liftover import liftover_mappings

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
