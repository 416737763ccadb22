"""Human-scale tools of the port: the stress dataset, and a bounded run of a
full contig index on one device.

`write_stress_dataset` is a copy of the generator of
``scripts/stress_scale.py`` (the same files, byte for byte, from the same
arguments): one random genome from ``default_rng(5)``, cut into contigs
with GAP-base gaps left out of the draft, and reads of READ_LEN bases drawn
across it with 4% substitutions, half of them reverse-complemented.
`gapped` puts three N runs into every contig (a later round's input), and
a marker file names the dataset, so that a directory holding another one
is emptied first. The JAX package's human preset is 750 contigs of 4 Mb
(3.0 Gbase) and 2,500,000 reads (30 Gbase, 10x).

`bounded_run` is ``scripts/stress_3g_bounded.py``'s measurement: the
contig index of such a target resident on one device, and a bounded slice
of its reads mapped against it (on-device chaining, the default run's
payload). It reports each step on its own (the contig sketch when there
is no sketch yet, at the default knobs through `sketch_target`: the card
and four C threads over one stream; the TSV parse, the bucket table's
build, its upload, the device's memory, the read slice's rate) and holds
two checks, raising
`ScaleCheckError` when either fails: the table read back from the device
equals the host's table byte for byte, and the first `check_reads` reads'
raw payloads equal those of `host_map.HostMapper`, the native C path that
shares no code with the device step.
"""
from __future__ import annotations

import itertools
import os
import resource
import shutil
import threading
import time

import numpy as np
import torch

from . import device as device_mod
from . import pipeline, step_graph
from .config import ScaffoldConfig
from .device_map import TorchMapper
from .host_map import HostMapper
from .index import ContigIndex
from .mapping_step import BUCKET, DeviceIndex
from .ops import sketch_cuda
from .seqio.fastx import stream_codes

SEED = 5
READ_LEN = 12_000
GAP = 500
K, W, Z = 32, 100, 1000
#: reads of the bounded slice, and how many of them are held against
#: HostMapper (stress_3g_bounded.py's default slice)
BOUNDED_READS = 20_000
CHECK_READS = 2_000


class ScaleCheckError(RuntimeError):
    """A check of `bounded_run` failed."""


def write_stress_dataset(workdir: str, n_contigs: int, contig_len: int,
                         n_reads: int, gapped: bool = False) -> None:
    """target.fa and reads.fa in `workdir`, as ``stress_scale.py`` writes
    them; a dataset of these arguments already there is kept."""
    os.makedirs(workdir, exist_ok=True)

    def path(name: str) -> str:
        return os.path.join(workdir, name)

    ascii_ = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    rng = np.random.default_rng(SEED)

    # the dataset's identity holds the gapped flag and the size: a cached
    # target.fa of another configuration would misstate what ran
    marker = path(
        f"target.fa.{'gapped' if gapped else 'gapless'}"
        f".{n_contigs}x{contig_len}.r{n_reads}"
    )
    if os.path.exists(path("target.fa")) and not os.path.exists(marker):
        for f in os.listdir(workdir):
            if os.path.isdir(path(f)):
                shutil.rmtree(path(f))
            else:
                os.remove(path(f))

    t0 = time.time()
    if os.path.exists(path("target.fa")):
        return
    # one uint8 ASCII genome; contigs are slices of it
    total_len = n_contigs * contig_len + (n_contigs - 1) * GAP
    genome = ascii_[rng.integers(0, 4, total_len, dtype=np.uint8)]
    with open(path("target.fa"), "wb") as fh:
        for i in range(n_contigs):
            off = i * (contig_len + GAP)
            ctg = genome[off : off + contig_len]
            if gapped:
                # interior N runs, as a later round's draft has them; the
                # reads still come from the gapless truth
                ctg = ctg.copy()
                for _ in range(3):
                    g0 = int(rng.integers(contig_len // 10, contig_len - 1000))
                    ctg[g0 : g0 + int(rng.integers(100, 800))] = ord("N")
            fh.write(b">c%d\n" % i)
            fh.write(ctg.tobytes())
            fh.write(b"\n")
    print(f"target written in {time.time()-t0:.1f}s", flush=True)

    chunk = 2048  # the gather index is chunk x READ_LEN int64 (~200 MB)
    err_n = int(READ_LEN * 0.04)
    with open(path("reads.fa"), "wb") as fh:
        for base_r in range(0, n_reads, chunk):
            n = min(chunk, n_reads - base_r)
            starts = rng.integers(0, total_len - READ_LEN, n)
            mat = genome[starts[:, None] + np.arange(READ_LEN)]
            # substitution errors
            rows = np.repeat(np.arange(n), err_n)
            cols = rng.integers(0, READ_LEN, n * err_n)
            mat[rows, cols] = ascii_[rng.integers(0, 4, n * err_n,
                                                  dtype=np.uint8)]
            # reverse-complement half the rows
            flip = rng.random(n) < 0.5
            mat[flip] = comp[mat[flip][:, ::-1]]
            for j in range(n):
                fh.write(b">r%d\n" % (base_r + j))
                fh.write(mat[j].tobytes())
                fh.write(b"\n")
    del genome
    open(marker, "w").close()
    print(
        f"dataset generated in {time.time()-t0:.1f}s "
        f"({n_contigs*contig_len/1e6:.0f} Mb target, "
        f"{n_reads*READ_LEN/1e6:.0f} Mb reads)",
        flush=True,
    )


def peak_rss_gib() -> float:
    """This process's peak resident set so far, GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


#: seconds between two samples of RssSampler
RSS_INTERVAL = 0.02


class RssSampler:
    """Context manager that samples this process's resident set every
    RSS_INTERVAL seconds on a thread of its own; `peak_gib` is the largest
    sample (unlike `peak_rss_gib`, it reads one span, not the process's
    life)."""

    def __init__(self):
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def rss_bytes() -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self) -> None:
        while True:
            self.peak = max(self.peak, self.rss_bytes())
            if self._stop.wait(RSS_INTERVAL):
                return

    @property
    def peak_gib(self) -> float:
        return self.peak / 2**30

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss_bytes())


def host_room(path: str) -> dict:
    """Free bytes on the file system of `path` and available memory (the
    `df` and `free` of the host)."""
    mem = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            key, value = line.split(":", 1)
            mem[key] = int(value.split()[0]) * 1024
    return {"disk_free": shutil.disk_usage(path).free,
            "mem_available": mem["MemAvailable"], "mem_total": mem["MemTotal"]}


def stress_bytes(n_contigs: int, contig_len: int, n_reads: int) -> int:
    """Bytes of the files a stress dataset and its contig sketch take: the
    two FASTA files and the TSV (about 26 bytes per minimizer, 2/(w+1)
    minimizers per base)."""
    target = n_contigs * (contig_len + 8)
    reads = n_reads * (READ_LEN + 12)
    return target + reads + sketch_tsv_bytes(n_contigs, contig_len)


def sketch_tsv_bytes(n_contigs: int, contig_len: int) -> int:
    """Bytes of the contig sketch TSV of such a target (about 26 bytes per
    minimizer, 2/(w+1) minimizers per base)."""
    return int(n_contigs * contig_len * 2 / (W + 1) * 26)


def _same_payload(a, b) -> bool:
    """Two (name, length, raw) items of a per-anchor stream carry the same
    read, the same anchor count and the same rpos, cid, cpos and strand
    bits (device rows carry no hash planes)."""
    if a[:2] != b[:2] or (a[2] is None) != (b[2] is None):
        return False
    if a[2] is None:
        return True
    n = a[2][0]
    return n == b[2][0] and all(
        np.array_equal(x[:n], y[:n]) for x, y in zip(a[2][1:5], b[2][1:5]))


def sketch_target(target: str, backend: str = None, device=None,
                  lengths: dict = None, log=print) -> tuple:
    """The `pair` stage's contig sketch of `target` (K, W) at `backend`, by
    default the run's, auto, with the run's four threads
    (``pipeline.ensure_contig_sketch_tsv``: auto with threads > 1 shares the
    stream between the card and the host's C threads); `lengths` are the
    target's contig lengths when the caller has read them. Returns
    (the TSV's path, the readings: wall seconds with the TSV, kernel
    launches, the card path's rows, chunked contigs, batches and host rows,
    the sequences each path delivered, Gbase/s, the peak host RSS sampled
    over the sketch), or (path, None) when a TSV was there already."""
    dev = device_mod.resolve(device)
    cfg = ScaffoldConfig(target=target, reads=[], k=K, w=W, z=Z)
    cfg.backend = backend or cfg.backend
    lengths = lengths or pipeline.read_scaffold_lengths(target)
    bases = sum(lengths.values())
    pipeline.last_sketcher = None
    launches0 = sketch_cuda.launches
    rss_before = RssSampler.rss_bytes()
    t0 = time.perf_counter()
    with RssSampler() as rss:
        tsv = pipeline.ensure_contig_sketch_tsv(cfg, K, W, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    sk = pipeline.last_sketcher
    if sk is None:
        return tsv, None
    # the card alone delivers every contig
    host_seqs = getattr(sk, "host_seqs", 0)
    device_seqs = getattr(sk, "device_seqs", len(lengths))
    out = {
        "backend": cfg.backend, "threads": cfg.t,
        "sketcher": type(sk).__name__,
        "seconds": secs,
        "stream_seconds": sk.stream_seconds,
        "launches": sketch_cuda.launches - launches0,
        "step_graphs": step_graph.counts(
            [getattr(sk, "device_backend", sk).graphs]),
        "device_rows": sk.device_rows, "chunked": sk.chunked,
        "host_fallbacks": sk.host_fallbacks,
        "batches_by_pad": {f"{L}{'N' if n else ''}": c for (L, n), c
                           in sk.batches_by_pad.items()},
        "device_batches": sum(sk.batches_by_pad.values()),
        "host_seqs": host_seqs, "device_seqs": device_seqs,
        "device_share": device_seqs / max(host_seqs + device_seqs, 1),
        "gbase_per_s": bases / sk.stream_seconds / 1e9,
        "peak_rss_gib": rss.peak_gib,
        "rss_before_gib": rss_before / 2**30,
    }
    log(f"contig sketch (backend={cfg.backend} t={cfg.t}, "
        f"{out['sketcher']}): {bases} bases in {secs:.1f} s with the TSV "
        f"(stream {sk.stream_seconds:.1f} s = {out['gbase_per_s']:.3f} "
        f"Gbase/s); card {device_seqs} of {host_seqs + device_seqs} contigs "
        f"({100 * out['device_share']:.1f}%), host {host_seqs}; "
        f"{out['launches']} sketch kernel launches for "
        f"{out['device_batches']} card batches, {sk.chunked} chunked "
        f"contigs, {sk.device_rows} card rows, batches by pad "
        f"{out['batches_by_pad']}, {sk.host_fallbacks} host-fallback rows; "
        f"peak host RSS {rss.peak_gib:.2f} GiB (sampled; "
        f"{out['rss_before_gib']:.2f} GiB before the sketch)")
    return tsv, out


def bounded_run(d: str, n_reads: int = BOUNDED_READS, device=None,
                check_reads: int = CHECK_READS, threads: int = 0,
                log=print) -> dict:
    """The contig index of `d`/target.fa on `device` (default the card) and
    the first `n_reads` reads of `d`/reads.fa mapped against it; sketches
    the target through the `pair` stage's contig path at the default knobs
    (`sketch_target`) when its TSV is not there yet. Returns the readings
    (seconds, counts, bytes, rates)."""
    dev = device_mod.resolve(device)
    cuda = dev.type == "cuda"
    target = os.path.join(d, "target.fa")
    reads = os.path.join(d, "reads.fa")
    out = {"device": torch.cuda.get_device_name(dev) if cuda else str(dev)}

    contig_lengths = pipeline.read_scaffold_lengths(target)
    out["target_bases"] = sum(contig_lengths.values())
    tsv, sketch = sketch_target(target, device=dev, lengths=contig_lengths,
                                log=log)
    if sketch is not None:
        out["sketch"] = sketch

    t0 = time.perf_counter()
    index = ContigIndex.from_tsv(tsv)
    n = len(index)
    out["parse"] = {"seconds": time.perf_counter() - t0, "minimizers": n,
                    "contigs": len(index.contig_names),
                    "tsv_bytes": os.path.getsize(tsv),
                    "peak_rss_gib": peak_rss_gib()}
    log(f"index parse: {n} minimizers, {len(index.contig_names)} contigs in "
        f"{out['parse']['seconds']:.1f} s, peak host RSS "
        f"{out['parse']['peak_rss_gib']:.2f} GiB")

    t0 = time.perf_counter()
    table = DeviceIndex.build_table(index.hashes, index.contig_ids,
                                    index.positions, index.strands)
    build_s = time.perf_counter() - t0
    t_bkt, mask, max_probes = table
    layout = table.layout
    out["table"] = {"seconds": build_s, "nb": layout.buckets,
                    "entries": layout.entries,
                    "max_probes": layout.max_probes,
                    "regime": layout.regime, "bytes": layout.table_bytes,
                    "gather_width": layout.max_probes * BUCKET}
    log(f"table build: {layout.describe()}, "
        f"{n / layout.buckets:.2f} entries per bucket, in {build_s:.1f} s")

    clen = np.array([contig_lengths[c] for c in index.contig_names],
                    np.int32)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    mapper = TorchMapper(index, K, W, device=dev, prechain=(clen, Z),
                         table=table)
    out["upload"] = {"seconds": mapper.upload_seconds}
    if cuda:
        free, total = torch.cuda.mem_get_info(dev)
        out["upload"].update(allocated=torch.cuda.memory_allocated(dev),
                             free=free, total=total)
    log(f"upload: {mapper.upload_seconds:.2f} s"
        + (f"; device memory allocated {out['upload']['allocated']} bytes, "
           f"free {free} of {total}" if cuda else ""))
    if not mapper.prechained:
        raise ScaleCheckError("the mapper does not chain on the device")

    back = mapper.didx.t_bkt.cpu().numpy().view(np.uint32)
    same = (back.shape == t_bkt.shape and np.array_equal(back, t_bkt)
            and (mapper.didx.mask, mapper.didx.max_probes)
            == (mask, max_probes))
    out["table_equal"] = bool(same)
    if not same:
        raise ScaleCheckError("the table read back from the device differs "
                              "from the host's")
    log(f"check: the table read back from {dev} equals the host's, "
        f"{t_bkt.nbytes} bytes")
    del back, table, t_bkt

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    kept = []
    n_mapped = bases = 0
    t0 = time.perf_counter()
    for item in mapper.map_stream_raw(
            itertools.islice(stream_codes(reads), n_reads)):
        if len(kept) < check_reads:
            kept.append(item)
        n_mapped += 1
        bases += item[1]
    if cuda:
        torch.cuda.synchronize(dev)
    map_s = time.perf_counter() - t0
    out["mapping"] = {
        "reads": n_mapped, "bases": bases, "seconds": map_s,
        "reads_per_s": n_mapped / map_s, "mbase_per_s": bases / map_s / 1e6,
        "host_fallbacks": mapper.host_fallbacks,
        "launches": mapper.kernel_launches,
        "step_graphs": mapper.graph_counts(),
        "peak_device_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                            if cuda else None),
        "peak_rss_gib": peak_rss_gib(),
    }
    m = out["mapping"]
    log(f"mapped {n_mapped} reads / {bases / 1e6:.0f} Mbase against the "
        f"full index in {map_s:.1f} s -> {m['reads_per_s']:.1f} reads/s, "
        f"{m['mbase_per_s']:.1f} Mbase/s; {mapper.kernel_launches} sketch "
        f"kernel launches, {mapper.host_fallbacks} host-fallback reads"
        + (f"; peak device memory {m['peak_device_mib']:.1f} MiB"
           if cuda else "")
        + f"; peak host RSS {m['peak_rss_gib']:.2f} GiB")

    host = HostMapper(index, K, W, threads=threads or os.cpu_count() or 1,
                      prechain=(clen, Z))
    t0 = time.perf_counter()
    want = list(host.map_stream_raw(
        itertools.islice(stream_codes(reads), len(kept))))
    host_s = time.perf_counter() - t0
    bad = [a[0] for a, b in zip(kept, want) if not _same_payload(a, b)]
    out["payloads_checked"] = len(kept)
    out["payloads_with_anchors"] = sum(a[2] is not None for a in kept)
    out["payloads_equal"] = not bad and len(want) == len(kept)
    if not out["payloads_equal"]:
        raise ScaleCheckError(
            f"{len(bad)} of {len(kept)} payloads differ from HostMapper's "
            f"(first: {bad[:3]})")
    log(f"check: {len(kept)} payloads ({out['payloads_with_anchors']} with "
        f"anchors) equal HostMapper's, read by read (host path "
        f"{len(kept) / host_s:.1f} reads/s on {host.threads} threads)")
    return out
