"""The step graphs' contract (``ntlink_tpu_torch/step_graph.py``) on the CPU,
with a stand-in for capture and replay that the tests inject: "capture"
runs the step once into its output, "replay" runs it again on the static
input buffers into that same output tensor, as a CUDA graph rewrites its
static output. A key's first batch runs the step eagerly; its second is
captured and replayed. The sketch kernel's wrapper is replaced by one that counts
as the card's does (a launch under capture is recorded, a replay runs no
Python and `StepGraphs` counts its launches), over the plain version.

Shown here: the key is what JAX's static arguments are plus the tensors a
graph bakes in, and a new `DeviceIndex` never replays another index's
graph; with batches in flight and keys interleaved every payload equals
the eager step's, the read stream as a whole equals ``ntlink_tpu``'s
DeviceMapper raw payloads, and the contig sketch stream the eager one's;
launch counts equal device batches; a capture that raises propagates."""
import numpy as np
import pytest
import torch

from ntlink_tpu.device_map import DeviceMapper
from ntlink_tpu.index import ContigIndex
from ntlink_tpu.ops import nthash_np
from ntlink_tpu_torch import mapping_step as ms
from ntlink_tpu_torch import step_graph, tracing
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.mapping_step import DeviceIndex, mapping_step, sketch_step
from ntlink_tpu_torch.ops import sketch_cuda, sketch_torch
from ntlink_tpu_torch.sketch import TorchSketcher
from ntlink_tpu_torch.stream_pipeline import copy_back

from .test_torch_device_map import K, W, _chimera, _dataset, _raws, _same, \
    _same_runs
from .test_torch_sketch_stream import MAX_PAD, _rows, _shrunk

CPU = torch.device("cpu")


class StandIn:
    """CPU stand-in of `step_graph.CudaGraph`."""

    #: "capture" or "replay" while one runs (read by the counting kernel)
    state = None

    def __init__(self, device, pool, stream):
        self.fn = self.out = None

    def capture(self, fn):
        StandIn.state = "capture"
        try:
            self.out = fn()
        finally:
            StandIn.state = None
        self.fn = fn
        return self.out

    def replay(self):
        StandIn.state = "replay"
        try:
            self.out.copy_(self.fn())
        finally:
            StandIn.state = None


class RaisingStandIn(StandIn):
    def capture(self, fn):
        raise RuntimeError("capture refused")


def counting_sketch_rows(codes, lengths, k, w):
    """The plain version, counted as the card's wrapper counts a launch."""
    if StandIn.state != "replay":
        sketch_cuda.count_launch(StandIn.state == "capture")
    return sketch_torch.sketch_rows_ref(codes, lengths, k, w)


@pytest.fixture
def counted(monkeypatch):
    monkeypatch.setattr(ms, "sketch_rows", counting_sketch_rows)
    monkeypatch.setattr(sketch_cuda, "launches", 0)
    monkeypatch.delenv("NTLINK_TORCH_PROFILE", raising=False)
    monkeypatch.setattr(tracing.GLOBAL, "torch_profile_dir", None)


def _stand_in(owner, graph_type=StandIn):
    """Give a mapper's replicas, or a sketcher, a stand-in graph set."""
    for o in getattr(owner, "_replicas", [owner]):
        o.graphs = step_graph.StepGraphs(CPU, graph_type=graph_type)
    return owner


def _batch(rng, B, pad, has_n, contigs):
    """A packed (B, pad) batch of reads cut from `contigs`, with N."""
    codes = np.zeros((B, pad), np.uint8)
    lengths = np.zeros(B, np.int32)
    for r in range(B - 1):  # the last row is padding
        n = int(rng.integers(pad // 2, pad + 1))
        c = contigs[r % len(contigs)]
        s = int(rng.integers(0, len(c) - n))
        codes[r, :n] = c[s : s + n]
        lengths[r] = n
    nmask = None
    if has_n:
        nbits = np.zeros((B, pad), bool)
        nbits[0, 300:340] = True
        nbits[1, 5] = True
        nmask = torch.from_numpy(np.packbits(nbits, axis=1,
                                             bitorder="little"))
    return (torch.from_numpy(ms.pack_codes(codes)), torch.from_numpy(lengths),
            nmask)


def _index(contigs):
    index = ContigIndex.from_sketches(
        (f"c{i}", nthash_np.sketch_codes(c, K, W))
        for i, c in enumerate(contigs))
    index.finalize()
    table = DeviceIndex.build_table(index.hashes, index.contig_ids,
                                    index.positions, index.strands)
    return DeviceIndex.from_numpy(*table), len(contigs)


KINDS = {
    "no chain": dict(runs=False, with_hashes=False, chain=False),
    "hash planes": dict(runs=False, with_hashes=True, chain=False),
    "anchors": dict(runs=False, with_hashes=False, chain=True),
    "runs-only": dict(runs=True, with_hashes=False, chain=True),
}


def _static(didx, clen, pad, kind):
    k = KINDS[kind]
    return dict(index=didx, k=K, w=W, L=pad, slots=256,
                clen=clen if k["chain"] else None, z=1000, runs=k["runs"],
                with_hashes=k["with_hashes"])


def test_keys_follow_the_static_arguments():
    rng = np.random.default_rng(3)
    contigs = [rng.integers(0, 4, 30_000).astype(np.uint8) for _ in range(2)]
    didx, n = _index(contigs)
    clen = torch.full((n,), 30_000, dtype=torch.int32)
    g = step_graph.StepGraphs(CPU, graph_type=StandIn)
    p, ln, nm = _batch(rng, 4, 1024, True, contigs)

    def key(pad=1024, kind="anchors", batch=None, step=mapping_step, **kw):
        static = {**_static(didx, clen, pad, kind), **kw}
        return g.key(step, batch or dict(packed=p, lengths=ln, nmask=nm),
                     static)

    base = key()
    assert key() == base
    others = [
        key(kind="no chain"), key(kind="hash planes"), key(kind="runs-only"),
        key(pad=2048), key(z=0), key(slots=512), key(k=24), key(w=50),
        key(batch=dict(packed=p, lengths=ln, nmask=None)),        # no N
        key(batch=dict(packed=p[:2], lengths=ln[:2], nmask=nm[:2])),  # B
        key(clen=clen.clone()),
        key(index=DeviceIndex(didx.t_bkt, didx.mask, didx.max_probes + 1)),
        # a new index of the same bytes is another index
        key(index=DeviceIndex(didx.t_bkt.clone(), didx.mask,
                              didx.max_probes)),
        key(step=sketch_step),
    ]
    assert len({base, *others}) == len(others) + 1
    # the same table under another DeviceIndex object is the same key
    assert key(index=DeviceIndex(didx.t_bkt, didx.mask,
                                 didx.max_probes)) == base
    assert base[0] == CPU


def test_a_new_index_never_replays_another_indexs_graph(counted):
    """Two indexes of other contigs at one shape: each gets its own graph,
    and each batch's payload is the eager step's on its own index."""
    rng = np.random.default_rng(4)
    a = [rng.integers(0, 4, 30_000).astype(np.uint8) for _ in range(2)]
    b = [rng.integers(0, 4, 30_000).astype(np.uint8) for _ in range(2)]
    (ia, _), (ib, _) = _index(a), _index(b)
    g = step_graph.StepGraphs(CPU, graph_type=StandIn)
    for idx, contigs in ((ia, a), (ib, b), (ia, a), (ib, b)):
        p, ln, nm = _batch(rng, 8, 1024, False, contigs)
        static = _static(idx, None, 1024, "no chain")
        got = copy_back(g.run(mapping_step, dict(packed=p, lengths=ln,
                                                 nmask=nm), static))[0]
        want = mapping_step(p, ln, nmask=nm, **static)
        assert torch.equal(got, want)
        assert int(got[:8].sum()) > 0  # anchors were found
    assert (g.captures, g.replays) == (2, 2)


@pytest.mark.parametrize("kind", list(KINDS))
def test_each_replay_refreshes_its_inputs_and_output(counted, kind):
    """Batches of two keys interleaved on one set: every payload, copied
    back before the next call as the stream does, equals the eager step's
    on its own batch (inputs refreshed, outputs not overwritten before
    they were read); launches equal batches."""
    rng = np.random.default_rng(5)
    contigs = [rng.integers(0, 4, 40_000).astype(np.uint8) for _ in range(3)]
    didx, n = _index(contigs)
    clen = torch.full((n,), 40_000, dtype=torch.int32)
    g = step_graph.StepGraphs(CPU, graph_type=StandIn)
    held = []
    for i in range(6):
        pad, has_n = ((1024, False), (2048, True))[i % 2]
        p, ln, nm = _batch(rng, 4, pad, has_n, contigs)
        static = _static(didx, clen, pad, kind)
        host, _ = copy_back(g.run(mapping_step, dict(packed=p, lengths=ln,
                                                     nmask=nm), static))
        held.append((host, mapping_step(p, ln, nmask=nm, **static)))
    for host, want in held:
        assert torch.equal(host, want)
    assert (g.captures, g.replays) == (2, 4)
    # the eager references launched 6 more
    assert sketch_cuda.launches == 6 + 6


@pytest.mark.parametrize("depth", ["1", "4"])
@pytest.mark.parametrize("mode", ["host-chained", "anchors", "runs-only"])
def test_read_stream_with_graphs_matches_device_mapper(counted, monkeypatch,
                                                       depth, mode):
    """The whole read stream with the stand-in graphs, NTLINK_PIPE_DEPTH
    batches in flight and keys (pads, N) interleaved, against
    ``ntlink_tpu``'s DeviceMapper raw payloads, read by read."""
    monkeypatch.setenv("NTLINK_PIPE_DEPTH", depth)
    index, reads, contigs = _dataset(with_contigs=True)
    reads = reads + [("chimera", _chimera(contigs))] + reads[3:40]
    prechain = None if mode == "host-chained" else (
        np.full(3, 150_000, np.int32), 1000)
    kw = dict(batch_bases=16384, prechain=prechain,
              runs_only=mode == "runs-only")
    tm = _stand_in(TorchMapper(index, K, W, device="cpu", **kw))
    got = _raws(tm, reads)
    dm = DeviceMapper(index, K, W, use_mesh=False, with_hashes=False, **kw)
    want = _raws(dm, reads)
    same = _same_runs if mode == "runs-only" else _same
    assert len(want) == len(got)
    for a, b in zip(got, want):
        same(a, b)
    captures, replays, _, first = tm.graph_counts()
    batches = sum(tm.batches_by_pad.values())
    assert captures > 3 and replays > 10 and first + replays == batches
    assert tm.kernel_launches == sketch_cuda.launches == batches
    assert tm.launches_by_device() == [batches]


def test_hash_planes_stream_with_graphs_matches_eager(counted):
    """repeats=True (hash planes) with the stand-in graphs, against the
    same mapper's eager steps, every plane."""
    index, reads = _dataset()
    kw = dict(batch_bases=16384, with_hashes=True)
    got = _raws(_stand_in(TorchMapper(index, K, W, device="cpu", **kw)),
                reads)
    want = _raws(TorchMapper(index, K, W, device="cpu", **kw), reads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a[:2] == b[:2] and (a[2] is None) == (b[2] is None)
        if a[2] is not None:
            assert a[2][0] == b[2][0]
            for x, y in zip(a[2][1:], b[2][1:]):
                assert np.array_equal(x, y), a[0]


def test_contig_sketch_with_graphs_matches_eager(counted):
    """TorchSketcher with the stand-in graphs: chunked rows, N rows and
    slot overflow, sequence by sequence against its eager steps;
    launches equal device batches."""
    rows = _rows(7, 15, 5)
    ts = _stand_in(_shrunk(TorchSketcher("cpu", batch_bases=2 * MAX_PAD),
                           2048))
    got = list(ts.sketch_stream(iter(rows), 15, 5))
    eager = _shrunk(TorchSketcher("cpu", batch_bases=2 * MAX_PAD), 2048)
    launches = sketch_cuda.launches
    want = list(eager.sketch_stream(iter(rows), 15, 5))
    for (na, la, ma), (nb, lb, mb) in zip(got, want):
        assert (na, la) == (nb, lb)
        for f in ("hashes", "positions", "forward"):
            assert np.array_equal(getattr(ma, f), getattr(mb, f)), na
    assert len(got) == len(want) == len(rows)
    batches = sum(ts.batches_by_pad.values())
    assert ts.graphs.warm_ups + ts.graphs.replays == batches
    assert ts.graphs.replays > 0
    assert ts.kernel_launches == launches == batches


def test_capture_error_propagates(counted):
    """A capture that raises fails the stream with its error: no batch
    quietly runs eagerly instead."""
    index, reads = _dataset()
    tm = _stand_in(TorchMapper(index, K, W, batch_bases=16384, device="cpu"),
                   RaisingStandIn)
    with pytest.raises(RuntimeError, match="capture refused"):
        _raws(tm, reads)
    ts = _stand_in(_shrunk(TorchSketcher("cpu", batch_bases=2 * MAX_PAD),
                           0), RaisingStandIn)
    with pytest.raises(RuntimeError, match="capture refused"):
        list(ts.sketch_stream(iter(_rows(7, 15, 5)), 15, 5))


def test_graphs_only_on_a_card_without_a_profile(monkeypatch):
    """The CPU and a device profile keep the steps eager; a CUDA device
    gets a set (made without a CUDA call: nothing is captured yet)."""
    monkeypatch.delenv("NTLINK_TORCH_PROFILE", raising=False)
    monkeypatch.setattr(tracing.GLOBAL, "torch_profile_dir", None)
    card = torch.device("cuda", 0)
    assert step_graph.for_device(CPU) is None
    assert isinstance(step_graph.for_device(card), step_graph.StepGraphs)
    monkeypatch.setenv("NTLINK_TORCH_PROFILE", "/nonexistent")
    assert step_graph.for_device(card) is None
    monkeypatch.delenv("NTLINK_TORCH_PROFILE")
    monkeypatch.setattr(tracing.GLOBAL, "torch_profile_dir", "/nonexistent")
    assert step_graph.for_device(card) is None
    index, _ = _dataset()
    assert TorchMapper(index, K, W, device="cpu")._replicas[0].graphs is None
    assert TorchSketcher("cpu").graphs is None
