"""Strongest pure-CPU mapping path (no device required).

`HostMapper` produces the same raw anchor payloads as
`device_map.TorchMapper.map_stream_raw`, so the native C chain/verbose/PAF
batch path (`pipeline._map_reads_native`) runs unchanged on top of it:

- sequence parsing is the native C reader (seqio/fastx stream_codes),
- per-read minimizer sketching + index join is one GIL-released C call
  (`native/sketch.c` sketch_join: rolling ntHash + deque window-min +
  binary-search probe of the sorted index arrays), so a small thread pool
  gives real CPU parallelism (the stand-in for btllib indexlr's `-t`
  threads, reference ntLink:199,221-225); the vectorized NumPy backend
  (`ops/nthash_np.sketch_codes` + `ContigIndex.lookup_many`) is the
  fallback when the C build is unavailable,
- chaining + artifact rendering stay in native C (`native/chain.c`).

This is the `backend=numpy` production path and the honest CPU baseline
leg of bench.py. Output is byte-identical to the device path (same exact
sketch semantics, same C chainer).
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from .index import ContigIndex
from .ops import nthash_np


class HostMapper:
    """Threaded NumPy sketch + vectorized hash join, raw-payload stream."""

    def __init__(self, index: ContigIndex, k: int, w: int,
                 threads: int = 4, depth: Optional[int] = None,
                 prechain=None, runs_only: bool = False):
        index.finalize()
        self.index = index
        self.k, self.w = k, w
        self.threads = max(1, int(threads))
        # prechain=(contig_lengths int32 in contig-id order, z): apply the
        # chaining acceptance stages IN THE WORKERS (exact C chain_select)
        # so the payload matches a prechained TorchMapper's — required
        # for hybrid splits where the device chains on-chip, and a free
        # parallelization of chaining (it moves off the consumer thread)
        self.prechained = False
        self._chain_sel = None
        self._chain_z = 0
        if prechain is not None:
            from .native import chain_module

            cm = chain_module()
            if cm is not None:
                clen_arr, z = prechain
                self._chain_sel = cm.Chainer(
                    np.ascontiguousarray(clen_arr, dtype=np.int32),
                    index.contig_names,
                )
                self._chain_z = int(z)
                self.prechained = True
        # runs-only payloads (non-verbose/non-PAF runs): the workers run
        # the FULL exact C chain (chain_batch) and ship only the per-run
        # summary rows — matches a runs_only TorchMapper's payload
        self.runs_only = bool(runs_only) and self.prechained
        # bounded look-ahead keeps memory O(depth * read_len) while letting
        # the pool stay busy ahead of the in-order consumer
        self.depth = depth or max(64, 16 * self.threads)
        self.contig_names = index.contig_names
        self._contig_order = {n: i for i, n in enumerate(index.contig_names)}
        from .native import sketch_module

        self._sm = sketch_module()
        if self._sm is not None:
            # zero-copy when the index arrays already have the right
            # dtype/layout (they do for finalized indexes)
            self._idx_bufs = (
                np.ascontiguousarray(index.hashes),
                np.ascontiguousarray(
                    np.asarray(index.contig_ids, dtype=np.int32)
                ),
                np.ascontiguousarray(
                    np.asarray(index.positions, dtype=np.int32)
                ),
                np.ascontiguousarray(
                    index.strands.view(np.uint8)
                    if index.strands.dtype == np.bool_
                    else np.asarray(index.strands, dtype=np.uint8)
                ),
            )

    def _select(self, length: int, raw):
        """Apply the chaining acceptance stages to a raw payload (exact C
        chain_select) when this mapper is prechained."""
        if raw is None or not self.prechained:
            return raw
        n, rpos, cid, cpos, sbits, hi, lo = raw
        sel = np.frombuffer(
            self._chain_sel.chain_select(
                np.ascontiguousarray(cid), np.ascontiguousarray(cpos),
                np.ascontiguousarray(rpos), np.ascontiguousarray(sbits),
                length, self.k, self._chain_z, 0, 0.0,
            ),
            np.int32,
        )
        if len(sel) == 0:
            return None
        return (
            len(sel),
            np.ascontiguousarray(rpos[sel]),
            np.ascontiguousarray(cid[sel]),
            np.ascontiguousarray(cpos[sel]),
            np.ascontiguousarray(sbits[sel]),
            np.ascontiguousarray(hi[sel]),
            np.ascontiguousarray(lo[sel]),
        )

    def _one(self, name: str, codes):
        name, length, raw = self._one_raw(name, codes)
        if self.runs_only:
            return self._runs_block([(name, length, raw)])[0]
        return name, length, self._select(length, raw)

    def _select_block(self, results):
        """Batched chaining acceptance for one pool task's results: ONE
        GIL-released C call (chain_select_batch) over the block's
        concatenated anchors, then vectorized re-slicing. The per-read
        chain_select form cost ~10% of the whole host leg in call
        overhead at t=4."""
        counts = [
            (raw[0] if raw is not None else 0) for _, _, raw in results
        ]
        total = sum(counts)
        if total == 0:
            return results
        offs = np.zeros(len(results) + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        cat = [np.empty(total, np.int32) for _ in range(6)]
        rlens = np.empty(len(results), np.int32)
        for i, (_, length, raw) in enumerate(results):
            rlens[i] = length
            if raw is None:
                continue
            o, n = int(offs[i]), raw[0]
            for a, src in zip(cat, raw[1:7]):
                a[o : o + n] = src
        rpos, cid, cpos, sbits, hi, lo = cat
        sel_b, no_b = self._chain_sel.chain_select_batch(
            cid, cpos, rpos, sbits, offs, rlens,
            self.k, self._chain_z, 0, 0.0,
        )
        sel = np.frombuffer(sel_b, np.int32)
        no = np.frombuffer(no_b, np.int32)
        out = []
        for i, (name, length, raw) in enumerate(results):
            a, b = int(no[i]), int(no[i + 1])
            if b == a:
                out.append((name, length, None))
                continue
            s = sel[a:b]
            out.append((
                name, length,
                (
                    b - a,
                    np.ascontiguousarray(rpos[s]),
                    np.ascontiguousarray(cid[s]),
                    np.ascontiguousarray(cpos[s]),
                    np.ascontiguousarray(sbits[s]),
                    np.ascontiguousarray(hi[s]),
                    np.ascontiguousarray(lo[s]),
                ),
            ))
        return out

    def _one_raw(self, name: str, codes):
        if not isinstance(codes, np.ndarray):
            codes = nthash_np.encode(codes)
        if len(codes) < self.k:
            return name, len(codes), None
        if self._sm is not None:
            res = self._sm.sketch_join(
                np.ascontiguousarray(codes, dtype=np.uint8),
                self.k, self.w, *self._idx_bufs,
            )
            if res is None:
                return name, len(codes), None
            n, rpos, cid, cpos, sbits, hi, lo = res
            return (
                name,
                len(codes),
                (
                    n,
                    np.frombuffer(rpos, np.int32),
                    np.frombuffer(cid, np.int32),
                    np.frombuffer(cpos, np.int32),
                    np.frombuffer(sbits, np.int32),
                    np.frombuffer(hi, np.int32),
                    np.frombuffer(lo, np.int32),
                ),
            )
        mins = nthash_np.sketch_codes(codes, self.k, self.w)
        found, cid, cpos, cstrand = self.index.lookup_many(mins.hashes)
        if not found.any():
            return name, len(codes), None
        hashes = mins.hashes[found]
        n = int(hashes.shape[0])
        rpos = mins.positions[found].astype(np.int32)
        sbits = (
            cstrand[found].astype(np.int32)
            | (mins.forward[found].astype(np.int32) << 1)
        )
        hi = (hashes >> np.uint64(32)).astype(np.uint32).view(np.int32)
        lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        return (
            name,
            len(codes),
            (
                n,
                np.ascontiguousarray(rpos),
                np.ascontiguousarray(cid[found].astype(np.int32)),
                np.ascontiguousarray(cpos[found].astype(np.int32)),
                np.ascontiguousarray(sbits),
                hi,
                lo,
            ),
        )

    #: reads per pool task: one future/queue/GIL round trip per BLOCK of
    #: reads instead of per read. The C sketch+join releases the GIL, but
    #: per-read futures cost ~30-50 us of GIL work each — at 4 saturated
    #: C threads that serialized ~1.5 s of pure Python per 30k reads and
    #: capped the hybrid's combined throughput (measured: the GIL, not
    #: the 4 cores, was the binding resource)
    TASK_READS = 64

    def _runs_block(self, results):
        """Runs-only payloads: ONE GIL-released chain_batch call over the
        block's concatenated anchors (full exact filters), shipping only
        the per-run summary rows [cid, count, f_cpos, f_rpos, f_sbits,
        l_cpos, l_rpos, l_sbits] — the tally consumes nothing else."""
        counts = [
            (raw[0] if raw is not None else 0) for _, _, raw in results
        ]
        total = sum(counts)
        if total == 0:
            return [(name, length, None) for name, length, _ in results]
        offs = np.zeros(len(results) + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        cat = [np.empty(total, np.int32) for _ in range(4)]
        rlens = np.empty(len(results), np.int32)
        for i, (_, length, raw) in enumerate(results):
            rlens[i] = length
            if raw is None:
                continue
            o, n = int(offs[i]), raw[0]
            for a, src in zip(cat, raw[1:5]):
                a[o : o + n] = src
        rpos, cid, cpos, sbits = cat
        runs_b, ro_b, _, _ = self._chain_sel.chain_batch(
            cid, cpos, rpos, sbits, offs, rlens,
            None, self.k, self._chain_z, 0, 0.0, 0, 0,
        )
        rr = np.frombuffer(runs_b, np.int32).reshape(-1, 8)
        ro = np.frombuffer(ro_b, np.int32)
        out = []
        for i, (name, length, _) in enumerate(results):
            a, b = int(ro[i]), int(ro[i + 1])
            out.append(
                (name, length, (b - a, rr[a:b]) if b > a else None)
            )
        return out

    def _one_block(self, items):
        results = [self._one_raw(name, codes) for name, codes in items]
        if self.runs_only:
            return self._runs_block(results)
        if self.prechained:
            results = self._select_block(results)
        return results

    def _pool(self) -> ThreadPoolExecutor:
        # ONE persistent pool per mapper, shared across map_stream_raw
        # calls: the hybrid scheduler ends and restarts this stream on
        # every idle flush (~15 times in a 30k-read run), and a fresh
        # ThreadPoolExecutor + shutdown per restart measured ~0.6 s each —
        # more than the entire host leg's compute for the interval
        ex = getattr(self, "_ex", None)
        if ex is None:
            ex = self._ex = ThreadPoolExecutor(max_workers=self.threads)
        return ex

    def map_stream_raw(
        self, named_codes: Iterable[Tuple[str, np.ndarray]]
    ) -> Iterator[Tuple[str, int, Optional[tuple]]]:
        """Yield (read_name, read_len, raw_payload) in input order."""
        if self.threads == 1:
            for name, codes in named_codes:
                yield self._one(name, codes)
            return
        ex = self._pool()
        window: deque = deque()   # block futures, in order
        block: list = []
        depth_blocks = max(2, -(-self.depth // self.TASK_READS))
        for item in named_codes:
            block.append(item)
            if len(block) >= self.TASK_READS:
                window.append(ex.submit(self._one_block, block))
                block = []
                if len(window) >= depth_blocks:
                    yield from window.popleft().result()
        if block:
            window.append(ex.submit(self._one_block, block))
        while window:
            yield from window.popleft().result()
