"""Shared three-thread scaffolding for the batched device streams.

Counterpart of ``ntlink_tpu/stream_pipeline.py`` without its
capped-transfer protocol (the port copies each batch's whole payload back).
Both hot loops (device_map.TorchMapper.map_stream_raw and
sketch.TorchSketcher.sketch_stream) split their work over three threads:

  producer (caller's thread): read / encode / pack / consume results
  feeder:   every device call: H2D copies, step dispatch, async D2H starts
  drainer:  the blocking waits on the device->host copies

FIFO queues (bounded depth -> backpressure) preserve batch order end to
end. Worker exceptions are captured and re-raised on the producer thread
at the next `join_all()`. Shutdown is bounded: a wedged worker (stuck
device call on a dead link) cannot hang the producer's generator-close
path — the sentinel put and the thread joins all time out, leaking only
daemon threads the process does not wait on.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List

import numpy as np


class DevicePipeline:
    """Feeder/drainer thread pair around caller-supplied batch handlers.

    `dispatch(*ent)` runs on the feeder thread; it should end by calling
    `submit_drain(ent2)` to forward the in-flight batch. `drain(*ent2)`
    runs on the drainer thread.
    """

    def __init__(
        self,
        dispatch: Callable[..., None],
        drain: Callable[..., None],
        depth: int = 2,
        name: str = "ntlink",
    ) -> None:
        self._dispatch = dispatch
        self._drain = drain
        self._feed_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._work_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.errors: List[BaseException] = []
        self._threads: List[threading.Thread] = []
        self._name = name

    # -- worker loops -----------------------------------------------------

    def _run_loop(self, q: "queue.Queue", fn) -> None:
        while True:
            ent = q.get()
            try:
                if ent is not None and not self.errors:
                    fn(*ent)
            except BaseException as exc:  # surfaced at next join_all()
                self.errors.append(exc)
            finally:
                q.task_done()
            if ent is None:
                return

    def _ensure_started(self) -> None:
        if self._threads:
            return
        for q, fn, suffix in (
            (self._work_q, self._drain, "drain"),
            (self._feed_q, self._dispatch, "feed"),
        ):
            t = threading.Thread(
                target=self._run_loop,
                args=(q, fn),
                daemon=True,
                name=f"{self._name}-{suffix}",
            )
            t.start()
            self._threads.append(t)

    # -- producer API -----------------------------------------------------

    def submit(self, ent: tuple) -> None:
        """Producer -> feeder (blocks on backpressure at queue depth)."""
        self._ensure_started()
        self._feed_q.put(ent)

    def submit_drain(self, ent: tuple) -> None:
        """Feeder -> drainer (called from inside `dispatch`)."""
        self._work_q.put(ent)

    def join_all(self) -> None:
        """Wait for every submitted batch to drain; re-raise worker errors."""
        self._feed_q.join()
        self._work_q.join()
        if self.errors:
            raise self.errors[0]

    def close(self, timeout: float = 60.0) -> None:
        """Bounded shutdown (see module docstring)."""
        if not self._threads:
            return
        for q in (self._feed_q, self._work_q):
            try:
                q.put(None, timeout=timeout)
            except queue.Full:
                pass
        for t in self._threads:
            t.join(timeout=timeout)


def next_pow2(n: int) -> int:
    """Next power of two >= n (>=1): batch heights and slot budgets come
    in a handful of reusable shapes."""
    n = max(1, n)
    p = 1
    while p < n:
        p <<= 1
    return p


def split_n_rows(row_codes: List[np.ndarray], B: int, pad: int):
    """For a batch of N-containing rows: return (clean_rows, packed_nmask).

    2-bit packing cannot carry N — clean the non-ACGT codes to 0 and build
    the (B, pad//8) little-bit-order non-ACGT mask that re-materializes
    them on device (2.25 bits/base wire total).
    """
    bad = np.zeros((B, pad), dtype=bool)
    clean = []
    for row, c in enumerate(row_codes):
        b = c > 3
        bad[row, : len(c)] = b
        clean.append(np.where(b, 0, c).astype(np.uint8))
    return clean, np.packbits(bad, axis=1, bitorder="little")
