"""The device steps as CUDA graphs, one per static key.

Counterpart of the JAX package's compiled steps: ``jax.jit`` of
``mesh.mapping_step_packed`` with its static arguments 5..16
(``ntlink_tpu/device_map.py:46-66``, `_single_device_step`) and of
``mesh.sketch_step_packed`` (``ntlink_tpu/ops/sketch_jax.py:348-356``).
XLA compiles one executable per static key, and each batch is one
dispatch of it. Here a `StepGraphs` captures the port's own step
(`mapping_step.mapping_step`, `mapping_step.sketch_step`) into one
``torch.cuda.CUDAGraph`` per key and replays it for every later batch of
that key: the step's ~160 kernel launches and copies (unpack, the sketch
kernel, select, gather, join, chaining, compaction) become one graph
launch.

The key (`StepGraphs.key`) is what JAX's static arguments are, plus what
a captured graph bakes in: the device; the step; each batch input's shape
and type (B rows of pad/4 packed bytes, B lengths) and whether an N mask
is there; the step's static arguments (k, w, pad, slots, z, the payload
kind: runs-only, per anchor with chaining, with hash planes, no chain);
and the identity of the tensors it reads besides the batch (the index
table with its mask and probe count, the contig lengths). Batch heights
are powers of two, so keys stay few.

First batch of a key: the step runs eagerly on the caller's stream (the
warm-up, whose payload is the batch's: the sketch kernel's build, its
seeds table and its shared-memory limit happen there, outside any
capture). Second batch: static input buffers are allocated on the device
and the batch is copied in, the step is captured on the set's capture
stream, and the graph replays. Every later batch: the batch is copied
into the static inputs and the graph replays. Copies and replays run on
the caller's stream, and the payload returned is the graph's static
output. The next replay of the key overwrites that output, so the caller
starts its copy to the host on the same stream before it hands the set
another batch, and stream order protects it. The capture waits for a
key's second batch because a read stream meets many keys only once (the
partial batches that each budget flush leaves at heights of their own)
and a capture beside a running stream costs tens of milliseconds
(PERF.md §6): a key seen once never pays for one, and every batch after
a key's first is a replay either way.

All graphs of a set share one memory pool. That is safe because they
replay one at a time in the order of one stream (a call from another
stream first waits for the last one) and each graph's output stays
allocated for the life of the set, so no other graph's scratch lands on
it. The set belongs to the `device_map.Replica` or the
`sketch.TorchSketcher` that made it and is freed with it. A capture that
fails raises: there is no return to the eager step.

The sketch kernel's launch inside a capture is recorded, not counted
(`ops.sketch_cuda.count_launch`); each replay counts the launches of its
graph (`sketch_cuda.count_replay`), so kernel launches still equal device
batches.

The hash-sharded step (``parallel/sharded_index.py``, the counterpart of
``jax.jit`` at ``ntlink_tpu/parallel/sharded_index.py:318``, ``:323`` and
``:344``) has a set per device of its grid, over that device's
`sharded_index.group_step`: its key holds, besides the batch's shapes
and N mask, the grid (its devices and cells), the batch height, k, w,
L, slots, `with_hashes`, the payload's finish and the identity of the
device's sub-tables and of the gpos offsets. The step forks each cell's
stream from the capture stream and joins it back, so the cells' work is
in the graph; on a grid of one device a batch is one replay.

The steps run eagerly on the CPU and while a device profile may be taken
(`for_device`): the ``record_function`` ranges by which a profile reads
the step's stages (`tracing.stage_device_times`) are not recorded on
replay.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from . import tracing
from .mapping_step import DeviceIndex
from .ops import sketch_cuda


class CudaGraph:
    """One step captured on a CUDA device: the graph type of `StepGraphs`
    (a test passes another with the same three methods)."""

    def __init__(self, device: torch.device, pool, stream):
        self.device, self.pool, self.stream = device, pool, stream
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        """Record `fn()` on the capture stream (nothing runs); returns its
        output, allocated in the pool. The capture is relaxed: no thread
        is refused the calls that are unsafe only beside a capture (the
        drainer's waits on other streams; another set's graph destroyed
        by the garbage collector, which may run at any allocation of the
        step, even on this thread), while anything the step itself does
        on the capture stream that a graph cannot hold, a wait on the card
        above all, still fails the capture."""
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            self.graph.capture_begin(pool=self.pool,
                                     capture_error_mode="relaxed")
            try:
                out = fn()
            except BaseException:
                # end the capture so that the stream works again; the
                # step's own error is the one to raise
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass
                raise
            self.graph.capture_end()
        return out

    def replay(self) -> None:
        """Launch the graph on the current stream."""
        self.graph.replay()


class _Entry:
    __slots__ = ("graph", "inputs", "output", "launches", "refs")

    def __init__(self, graph, inputs, output, launches, refs):
        self.graph = graph
        self.inputs = inputs
        self.output = output
        #: sketch kernel launches recorded in the graph
        self.launches = launches
        #: the objects whose identity is in the key, held so that no other
        #: object can take their id while the graph lives
        self.refs = refs


def _ident(value, refs: list):
    """A static argument as it enters a key: a tensor or an index by the
    identity of what it reads, a tuple by its items, anything else by
    value (an object without its own equality, by its identity)."""
    if isinstance(value, DeviceIndex):
        refs += [value, value.t_bkt]
        return ("index", id(value.t_bkt), value.mask, value.max_probes)
    if isinstance(value, torch.Tensor):
        refs.append(value)
        return ("tensor", id(value))
    if isinstance(value, tuple):
        return tuple(_ident(v, refs) for v in value)
    return value


class StepGraphs:
    """The captured steps of one owner on one device, by static key."""

    def __init__(self, device, graph_type=CudaGraph):
        self.device = torch.device(device)
        self.graph_type = graph_type
        self._entries: Dict[tuple, _Entry] = {}
        #: keys whose first batch ran eagerly, with the objects their
        #: identity holds (so that no other object takes their id)
        self._warm: Dict[tuple, list] = {}
        self._pool = None
        self._capture_stream = None
        self._last_stream = None
        #: first batches run eagerly, graphs captured, replays, and host
        #: seconds spent capturing (the warm-ups are not in it)
        self.warm_ups = 0
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def key(self, step, batch: dict, static: dict, refs: Optional[list] = None
            ) -> tuple:
        """The static key of one call (see the module's text). `refs`, if
        given, receives the objects whose identity the key holds."""
        refs = [] if refs is None else refs
        shapes = tuple(
            (name, None if t is None else (tuple(t.shape), t.dtype))
            for name, t in sorted(batch.items()))
        statics = tuple((name, _ident(v, refs))
                        for name, v in sorted(static.items()))
        return (self.device, step, shapes, statics)

    def run(self, step, batch: Dict[str, Optional[torch.Tensor]],
            static: dict) -> torch.Tensor:
        """`step(**batch, **static)` for one batch (`batch`: host tensors,
        pinned on a CUDA device, or None): the step itself for the first
        batch of its key, else the key's graph replayed on the batch,
        captured first at the key's second batch. Returns the step's
        output on the device; a replay's is the graph's static output (see
        the module's text)."""
        refs: list = []
        key = self.key(step, batch, static, refs)
        entry = self._entries.get(key)
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            if self._last_stream is not None and self._last_stream != cur:
                cur.wait_stream(self._last_stream)
            self._last_stream = cur
        if entry is None and key not in self._warm:
            self._warm[key] = refs
            self.warm_ups += 1
            return step(**{n: None if t is None
                           else t.to(self.device, non_blocking=True)
                           for n, t in batch.items()}, **static)
        if entry is None:
            entry = self._capture(key, step, batch, static)
        else:
            for name, t in batch.items():
                if t is not None:
                    entry.inputs[name].copy_(t, non_blocking=True)
        entry.graph.replay()
        self.replays += 1
        sketch_cuda.count_replay(entry.launches)
        return entry.output

    def _capture(self, key, step, batch, static) -> _Entry:
        """Static inputs holding `batch`, and the step's graph on them."""
        t0 = time.perf_counter()
        inputs = {
            name: None if t is None
            else torch.empty(t.shape, dtype=t.dtype, device=self.device)
            for name, t in batch.items()}
        for name, t in batch.items():
            if t is not None:
                inputs[name].copy_(t, non_blocking=True)
        if self.device.type == "cuda" and self._capture_stream is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        graph = self.graph_type(self.device, self._pool, self._capture_stream)
        n0 = sketch_cuda.recorded_launches()
        output = graph.capture(lambda: step(**inputs, **static))
        entry = self._entries[key] = _Entry(
            graph, inputs, output, sketch_cuda.recorded_launches() - n0,
            self._warm.pop(key) + [static])
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return entry


def for_device(device: torch.device) -> Optional[StepGraphs]:
    """A new graph set for an owner on `device`, or None where the steps
    run eagerly: on the CPU, and while a device profile may be taken
    (`tracing.profiling`)."""
    if device.type != "cuda" or tracing.profiling():
        return None
    return StepGraphs(device)


def counts(sets) -> Optional[tuple]:
    """(captures, replays, capture seconds, warm-ups) summed over graph
    sets (None for an owner whose steps run eagerly); None when every
    step is eager."""
    sets = [g for g in sets if g is not None]
    if not sets:
        return None
    return (sum(g.captures for g in sets), sum(g.replays for g in sets),
            sum(g.capture_seconds for g in sets),
            sum(g.warm_ups for g in sets))


def summary(after: Optional[tuple], before: Optional[tuple] = None) -> str:
    """Step graphs for a log line, from `counts`: since `before` (a
    stream's summary line), or all of them."""
    if after is None:
        return "steps eager"
    c, r, s, w = (a - b for a, b in zip(after, before or (0,) * 4))
    return (f"step graphs: {c} captured in {s:.3f} s, {r} replays, {w} "
            f"first batches eager")
