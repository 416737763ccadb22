"""Streaming FASTA/FASTQ IO.

Record-splitting semantics follow lh3 readfq (the reference vendors the same
parser as bin/read_fasta.py:6-46): header token is the first whitespace-split
word, multi-line sequences are joined, FASTQ quality runs until it reaches the
sequence length. Transparent gzip handling.
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, Iterable, Optional


@dataclass
class FastxRecord:
    name: str
    seq: str
    comment: Optional[str] = None
    qual: Optional[str] = None

    def __len__(self) -> int:
        return len(self.seq)


def open_text_maybe_gzip(path: str) -> io.TextIOBase:
    """Open a text file, transparently decompressing gzip (by magic bytes)."""
    raw = open(path, "rb")
    magic = raw.read(2)
    raw.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=raw), encoding="ascii")
    return io.TextIOWrapper(raw, encoding="ascii")


def stream_fastx(source, native: bool = True) -> Iterator[FastxRecord]:
    """Yield records from a path or an open text stream (FASTA or FASTQ).

    Paths go through the native C reader (gzip + parse in C) when it is
    available; streams and fallback use the pure-Python readfq parser.
    """
    if isinstance(source, str):
        if native:
            from ..native import fastx_module

            mod = fastx_module()
            if mod is not None:
                for name, comment, seq, qual in mod.Reader(source):
                    yield FastxRecord(
                        name,
                        seq.decode("ascii"),
                        comment,
                        qual.decode("ascii") if qual is not None else None,
                    )
                return
        fh = open_text_maybe_gzip(source)
        try:
            yield from _parse(fh)
        finally:
            fh.close()
        return
    yield from _parse(source)


def stream_codes(path: str):
    """Yield (name, base-code uint8 array) per record — the mapping hot
    path's input. Uses the native reader's in-C encoder when available."""
    import numpy as np

    from ..native import fastx_module

    mod = fastx_module()
    if mod is not None:
        for name, _, payload, _ in mod.Reader(path, codes=True):
            yield name, np.frombuffer(payload, dtype=np.uint8)
        return
    from ..ops import nthash_np

    for rec in stream_fastx(path, native=False):
        yield rec.name, nthash_np.encode(rec.seq)


def scan_selected_reads(path: str, wanted):
    """Yield (name, seq_str) for records whose name is in `wanted`,
    decoding ONLY those. The gap-fill read sweep visits every record of
    the read set to keep a few hundred chosen reads; skipping the str
    decode + FastxRecord construction for the 99.97% unwanted records
    roughly halves the sweep at 30 Gbase."""
    from ..native import fastx_module

    mod = fastx_module()
    if mod is not None:
        for name, _, seq, _ in mod.Reader(path):
            if name in wanted:
                yield name, seq.decode("ascii")
        return
    for rec in stream_fastx(path, native=False):
        if rec.name in wanted:
            yield rec.name, rec.seq


def _parse(fh) -> Iterator[FastxRecord]:
    pending = None  # header line carried over between records
    while True:
        if pending is None:
            for line in fh:
                if line and line[0] in ">@":
                    pending = line.rstrip("\n")
                    break
            else:
                return
        header = pending[1:]
        fields = header.split(None, 1)
        name = fields[0] if fields else ""
        comment = fields[1] if len(fields) > 1 else None
        pending = None

        seq_parts = []
        for line in fh:
            if line and line[0] in ">@+":
                pending = line.rstrip("\n")
                break
            seq_parts.append(line.rstrip("\n"))
        seq = "".join(seq_parts)

        if pending is None or not pending.startswith("+"):
            yield FastxRecord(name, seq, comment, None)
            if pending is None:
                return
            continue

        # FASTQ: read quality until it covers the sequence
        pending = None
        qual_parts, qlen = [], 0
        for line in fh:
            stripped = line.rstrip("\n")
            qual_parts.append(stripped)
            qlen += len(stripped)
            if qlen >= len(seq):
                yield FastxRecord(name, seq, comment, "".join(qual_parts))
                break
        else:
            # EOF before enough quality: degrade to FASTA (readfq behaviour)
            yield FastxRecord(name, seq, comment, None)
            return


def read_fasta_lengths(path: str) -> dict:
    """Map sequence name -> length (reference ntlink_utils.py:65-73)."""
    return {rec.name: len(rec.seq) for rec in stream_fastx(path)}


_RC = str.maketrans(
    "ACGTUNMRWSYKVHDBacgtunmrwsykvhdb",
    "TGCAANKYWSRMBDHVtgcaankywsrmbdhv",
)


def reverse_complement(seq: str) -> str:
    """IUPAC-aware reverse complement (reference ntlink_patch_gaps.py:47-53)."""
    return seq[::-1].translate(_RC)


def prefetch_iter(iterable, depth: int = 256):
    """Run an iterable on a background thread with a bounded queue.

    Overlaps input parsing/decompression with downstream (device) work.
    Exceptions propagate to the consumer; the thread is daemonic so an
    abandoned consumer cannot hang interpreter exit.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()

    def worker():
        try:
            for item in iterable:
                q.put(item)
            q.put(DONE)
        except BaseException as exc:  # propagate into the consumer
            q.put(exc)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def prefetch_files(paths, make_iter, threads: int = 1, depth: int = 256):
    """Yield `(path, record-iterator)` in input order while parsing up to
    `threads` files concurrently on background threads.

    The pigz-equivalent of the reference pipeline (parallel decompression,
    reference ntLink:112-117): file i is consumed in order — so every
    order-sensitive artifact (verbose TSV, pairs.tsv, per-file multi-host
    parts) is byte-identical to a serial run — while files i+1..i+threads-1
    decompress/parse into bounded queues in the background. The native C
    reader releases the GIL for the whole record parse, so the workers run
    truly in parallel with host-side chaining and with each other.

    With threads=1 this degrades to exactly `prefetch_iter` per file
    (single readahead worker for the current file only).
    """
    import queue
    import threading

    DONE = object()
    queues = [queue.Queue(maxsize=depth) for _ in paths]
    slots = threading.BoundedSemaphore(max(1, threads))
    # Abandonment protocol: if the consumer stops early (an error elsewhere
    # in the run), `stop` flips and every worker unblocks from its bounded
    # put, closes its source iterator (releasing the underlying file
    # handle), and exits — nothing stays pinned for the life of the process
    # (the rounds flow calls this many times in one process).
    stop = threading.Event()

    def _put(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker(path, q):
        try:
            it = make_iter(path)
            try:
                for item in it:
                    if not _put(q, item):
                        return
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            _put(q, DONE)
        except BaseException as exc:  # propagate into the consumer
            _put(q, exc)
        finally:
            slots.release()

    def launcher():
        for path, q in zip(paths, queues):
            slots.acquire()
            if stop.is_set():
                slots.release()
                return
            threading.Thread(
                target=worker, args=(path, q), daemon=True
            ).start()

    threading.Thread(target=launcher, daemon=True).start()

    def drain(q):
        while True:
            item = q.get()
            if item is DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    try:
        for path, q in zip(paths, queues):
            yield path, drain(q)
    finally:
        stop.set()
        for q in queues:  # free one slot so a mid-put worker can finish
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def write_fasta(fh, records: Iterable, wrap: Optional[int] = None) -> None:
    """Write (header, seq) pairs; header is emitted verbatim after '>'."""
    for header, seq in records:
        fh.write(f">{header}\n")
        if wrap:
            for i in range(0, len(seq), wrap):
                fh.write(seq[i : i + wrap] + "\n")
        else:
            fh.write(seq + "\n")
