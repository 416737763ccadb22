"""The hash-sharded step's graphs (``parallel/sharded_index.py`` over
``step_graph.StepGraphs``) on the CPU, with the stand-in graph type of
``test_torch_step_graph.py``: "capture" runs the step once into its
output, "replay" runs it again on the static inputs into that same
output, and the sketch kernel's wrapper counts as the card's does.

Grids of ``"cpu"`` put every cell on one device, so a batch is one step
(one replay) as on a card named twice; grids of ``"cpu:0"``, ``"cpu:1"``,
... are distinct devices, each with a graph set of its own, the other
devices' results copied into the first device's static inputs between
the replays. Shown, with tolerance 0: every payload equals the eager
step's and ``ntlink_tpu``'s `make_sharded_index_mapping_step` (plain, N
batch, hash planes) and `make_sharded_index_join`; the read stream with
graphs equals the eager stream; a key is captured at its second batch;
another `ShardedDeviceIndex` never replays this one's graph; a capture
error propagates; each replay counts one sketch launch per idx rank."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntlink_tpu.index import ContigIndex
from ntlink_tpu.ops import nthash_np
from ntlink_tpu.parallel import sharded_index as ref
from ntlink_tpu.parallel.mesh import pack_codes
from ntlink_tpu_torch import step_graph, tracing
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.ops import sketch_cuda
from ntlink_tpu_torch.parallel import sharded_index as port

from .test_torch_device_map import _dataset, _raws
from .test_torch_sharded_index import _mesh
from .test_torch_step_graph import RaisingStandIn, StandIn, \
    counting_sketch_rows

K, W, L, B, SLOTS = 32, 100, 4096, 4, 256

#: (data, idx) grids: the devices of each, row by row
GRIDS = {
    "1x2": ["cpu"] * 2,
    "2x2": ["cpu"] * 4,
    "1x4": ["cpu"] * 4,
    "2x2 distinct": [f"cpu:{i}" for i in range(4)],
}
IDX = {"1x2": 2, "2x2": 2, "1x4": 4, "2x2 distinct": 2}


@pytest.fixture
def counted(monkeypatch):
    monkeypatch.setattr(port, "sketch_rows", counting_sketch_rows)
    monkeypatch.setattr(sketch_cuda, "launches", 0)
    monkeypatch.delenv("NTLINK_TORCH_PROFILE", raising=False)
    monkeypatch.setattr(tracing.GLOBAL, "torch_profile_dir", None)


@pytest.fixture
def stand_in_sets(monkeypatch):
    """Every graph set made from here on is a stand-in set."""
    monkeypatch.setattr(step_graph, "for_device", lambda d: (
        step_graph.StepGraphs(d, graph_type=StandIn)))


def _contigs(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, 20_000).astype(np.uint8) for _ in range(3)]


def _index(contigs):
    return ContigIndex.from_sketches(
        (f"c{i}", nthash_np.sketch_codes(c, K, W))
        for i, c in enumerate(contigs))


def _batches(contigs, n, variant, seed):
    """`n` batches of B reads cut from `contigs` (the last half random),
    with N bases (zeroed codes + mask) for the "n-batch" variant: (codes,
    packed, lengths, nmask or None) as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        codes = np.zeros((B, L), np.uint8)
        for r in range(B):
            c = contigs[r % 3]
            s = int(rng.integers(0, len(c) - L))
            codes[r] = c[s : s + L]
        codes[B - 1, L // 2 :] = rng.integers(0, 4, L - L // 2)
        lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
        lengths[0] = L
        nmask = None
        if variant == "n-batch":
            bad = np.zeros((B, L), bool)
            bad[:, int(rng.integers(100, 2000)):][:, :40] = True
            bad[1, 0] = True
            codes = np.where(bad, 0, codes).astype(np.uint8)
            nmask = np.packbits(bad, axis=1, bitorder="little")
        out.append((codes, pack_codes(codes), lengths, nmask))
    return out


def _torch(b):
    _, packed, lengths, nmask = b
    return (torch.from_numpy(packed), torch.from_numpy(lengths),
            None if nmask is None else torch.from_numpy(nmask))


def _step(index, grid, with_hashes=False):
    n_idx = IDX[grid]
    sidx = port.ShardedDeviceIndex.from_contig_index(index, n_idx)
    return port.make_sharded_index_mapping_step(
        port.make_mesh_2d(n_idx, GRIDS[grid]), sidx, K, W, L, SLOTS,
        with_hashes=with_hashes)


def _stand_in(step, graph_type=StandIn):
    step.graphs = [step_graph.StepGraphs(g.device, graph_type=graph_type)
                   for g in step.groups]
    return step


def _counts(step):
    return step_graph.counts(step.graphs)


@pytest.mark.parametrize("variant", ["plain", "n-batch", "hashes"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_step_graphs_equal_eager_and_the_jax_step(counted, grid, variant):
    """Three batches of one key through the stand-in graphs (eager,
    captured and replayed, replayed): every {flat, n_anchors} equals the
    eager step's and the JAX step's on its own batch, byte for byte."""
    contigs = _contigs(3)
    index = _index(contigs)
    with_hashes = variant == "hashes"
    graphed = _stand_in(_step(index, grid, with_hashes))
    eager = _step(index, grid, with_hashes)
    assert all(g is None for g in eager.graphs)
    n_data = 2 if grid.startswith("2x2") else 1
    r_step = ref.make_sharded_index_mapping_step(
        _mesh(n_data, IDX[grid]),
        ref.ShardedDeviceIndex.from_contig_index(index, IDX[grid]), K, W, L,
        SLOTS, with_hashes=with_hashes)
    for b in _batches(contigs, 3, variant, seed=len(grid) + len(variant)):
        got = graphed(*_torch(b)[:2], nmask=_torch(b)[2])
        want = eager(*_torch(b)[:2], nmask=_torch(b)[2])
        _, packed, lengths, nmask = b
        r_out = r_step(jnp.asarray(packed), jnp.asarray(lengths),
                       nmask=None if nmask is None else jnp.asarray(nmask))
        assert torch.equal(got["flat"], want["flat"])
        flat, r_flat = got["flat"].numpy(), np.asarray(r_out["flat"])
        n = int(got["n_anchors"])
        assert n == int(want["n_anchors"]) == int(r_out["n_anchors"]) > 20
        assert flat.shape == r_flat.shape == (
            1 + 2 + 2 * with_hashes, B * SLOTS)
        assert np.array_equal(flat[0], r_flat[0])
        assert np.array_equal(flat[1:, :n], r_flat[1:, :n])
    n_sets = len({d for d in GRIDS[grid]})
    assert len(graphed.graphs) == n_sets
    for g in graphed.graphs:
        assert (g.warm_ups, g.captures, g.replays) == (1, 1, 2)


@pytest.mark.parametrize("grid", ["1x4", "2x2 distinct"])
def test_replays_count_one_launch_per_idx_rank(counted, grid):
    """Kernel launches over a key's batches (eager, capture, replays)
    equal batches x cells: a launch under capture is recorded, and each
    replay of each device's graph counts its cells' launches."""
    contigs = _contigs(4)
    step = _stand_in(_step(_index(contigs), grid))
    batches = _batches(contigs, 4, "plain", seed=9)
    for i, b in enumerate(batches, 1):
        step.flat(*_torch(b))
        assert sketch_cuda.launches == i * len(GRIDS[grid])
    assert _counts(step)[:2] == (len(step.graphs), 3 * len(step.graphs))


def test_capture_comes_at_a_keys_second_batch(counted):
    """First batch of a key eager, second captured and replayed, later
    ones replayed; an N batch is another key, and so is another height."""
    contigs = _contigs(5)
    step = _stand_in(_step(_index(contigs), "1x2"))
    (g,) = step.graphs
    plain = _batches(contigs, 3, "plain", seed=1)
    seen = []
    for b in plain:
        step.flat(*_torch(b))
        seen.append((g.warm_ups, g.captures, g.replays))
    assert seen == [(1, 0, 0), (1, 1, 1), (1, 1, 2)]
    nb = _batches(contigs, 2, "n-batch", seed=2)
    step.flat(*_torch(nb[0]))
    assert (g.warm_ups, g.captures, g.replays) == (2, 1, 2)
    step.flat(*_torch(nb[1]))
    assert (g.warm_ups, g.captures, g.replays) == (2, 2, 3)
    p, ln, _ = _torch(plain[0])
    step.flat(p[:2], ln[:2])
    assert (g.warm_ups, g.captures, g.replays) == (3, 2, 3)


def test_a_new_sharded_index_never_replays_another_ones_graph(counted):
    """Two indexes of other contigs at one shape: their keys differ (the
    grid, its sub-tables and gpos offsets are in the key), and batches
    alternating between the two steps each get their own index's payload."""
    a, b = _contigs(6), _contigs(7)
    sa, sb = (_stand_in(_step(_index(c), "1x2")) for c in (a, b))
    ga = sa.graphs[0]
    batch = dict(zip(("packed", "lengths", "nmask"),
                     _torch(_batches(a, 1, "plain", seed=3)[0])))
    ka = ga.key(port.group_step, batch,
                sa.grid.static(0, B, "flat", False, sa.t_off))
    kb = ga.key(port.group_step, batch,
                sb.grid.static(0, B, "flat", False, sb.t_off))
    assert ka != kb
    for other in (sa.grid.static(0, B, "flat", True, sa.t_off),
                  sa.grid.static(0, B, "rows", False, sa.t_off),
                  sa.grid.static(0, B, "flat", False, sa.t_off.clone()),
                  sa.grid.static(0, 2 * B, "flat", False, sa.t_off)):
        assert ga.key(port.group_step, batch, other) != ka
    assert ga.key(port.group_step, batch,
                  sa.grid.static(0, B, "flat", False, sa.t_off)) == ka
    ea, eb = _step(_index(a), "1x2"), _step(_index(b), "1x2")
    for i in range(3):
        for step, eager, contigs in ((sa, ea, a), (sb, eb, b)):
            bt = _torch(_batches(contigs, 1, "plain", seed=10 + i)[0])
            got = step(*bt[:2])["flat"]
            assert torch.equal(got, eager(*bt[:2])["flat"])
            assert int(got[0, :B].sum()) > 20
    assert _counts(sa)[:2] == _counts(sb)[:2] == (1, 2)


@pytest.mark.parametrize("grid", ["2x4", "2x2 distinct"])
def test_join_through_graphs_equals_the_jax_join(counted, stand_in_sets,
                                                 grid):
    """`make_sharded_index_join` replays its grid's graphs; each call's
    (count, anchors) equals ``ntlink_tpu``'s join on the same codes."""
    contigs = _contigs(8)
    index = _index(contigs)
    devices = ["cpu"] * 8 if grid == "2x4" else GRIDS[grid]
    n_idx = 4 if grid == "2x4" else 2
    join = port.make_sharded_index_join(
        port.make_mesh_2d(n_idx, devices),
        port.ShardedDeviceIndex.from_contig_index(index, n_idx), K, W,
        max_anchors=SLOTS)
    r_join = ref.make_sharded_index_join(
        _mesh(2, n_idx), ref.ShardedDeviceIndex.from_contig_index(
            index, n_idx), K, W, max_anchors=SLOTS)
    for codes, _, lengths, _ in _batches(contigs, 3, "plain", seed=4):
        count, anchors = join(codes, lengths)
        r_count, r_anchors = r_join(codes, lengths)
        assert count.dtype == anchors.dtype == torch.int32
        assert np.array_equal(count.numpy(), np.asarray(r_count))
        assert np.array_equal(anchors.numpy(), np.asarray(r_anchors))
        assert int(count.sum()) > 20
    ((_, graphs),) = join.grids.values()
    assert len(graphs) == len(set(devices))
    assert step_graph.counts(graphs)[:2] == (len(graphs), 2 * len(graphs))


@pytest.mark.parametrize("repeats", [False, True])
@pytest.mark.parametrize("grid", ["1x2", "2x2 distinct"])
def test_read_stream_with_graphs_equals_eager(counted, monkeypatch, grid,
                                              repeats):
    """The hash-sharded read stream with the stand-in graphs, keys (pads,
    N) interleaved and batches in flight, against the same mapper's eager
    steps, read by read and plane by plane (hash planes with repeats);
    launches equal device batches x idx ranks, counted over the data rows
    that hold rows (a one-read batch leaves the first of two empty)."""
    index, reads = _dataset()
    reads = reads + reads[3:40]
    kw = dict(batch_bases=16384, devices=GRIDS[grid], with_hashes=repeats,
              index_sharding="hash", idx_shards=2)
    want = _raws(TorchMapper(index, K, W, **kw), reads)
    assert sketch_cuda.launches > 0
    monkeypatch.setattr(sketch_cuda, "launches", 0)
    monkeypatch.setattr(step_graph, "for_device", lambda d: (
        step_graph.StepGraphs(d, graph_type=StandIn)))
    heights = []
    real_run = port._Grid.run

    def run(grid, packed, *args):
        heights.append(packed.shape[0])
        return real_run(grid, packed, *args)

    monkeypatch.setattr(port._Grid, "run", run)
    tm = TorchMapper(index, K, W, **kw)
    got = _raws(tm, reads)
    assert len(got) == len(want) == len(reads)
    for a, b in zip(got, want):
        assert a[:2] == b[:2] and (a[2] is None) == (b[2] is None), a[0]
        if a[2] is not None:
            assert a[2][0] == b[2][0], a[0]
            for x, y in zip(a[2][1:], b[2][1:]):
                assert np.array_equal(x, y), a[0]
    captures, replays, _, first = tm.graph_counts()
    assert len(heights) == sum(tm.batches_by_pad.values())
    n_data = len(GRIDS[grid]) // 2
    # each device's step runs when its data row holds rows (the first
    # device's always: it makes the payload); each cell of a row that holds
    # rows launches once
    held = [[B * (d + 1) // n_data > B * d // n_data for d in range(n_data)]
            for B in heights]
    if n_data == 1:
        steps = len(heights)  # one device: one step a batch
    else:  # cpu:0 row 0 rank 0, cpu:1 row 0 rank 1, cpu:2 and cpu:3 row 1
        steps = sum(1 + h[0] + 2 * h[1] for h in held)
        assert not all(h[0] for h in held)  # a one-read batch was there
    assert captures > 2 and replays > 4
    assert first + replays == steps
    launches = 2 * sum(map(sum, held))
    assert tm.kernel_launches == sketch_cuda.launches == launches
    assert tm.launches_by_device() == [launches]


def test_capture_error_propagates(counted, monkeypatch):
    """A capture that raises fails the hash-sharded stream with its error,
    and the join with it: no batch quietly runs eagerly instead."""
    monkeypatch.setattr(step_graph, "for_device", lambda d: (
        step_graph.StepGraphs(d, graph_type=RaisingStandIn)))
    index, reads = _dataset()
    tm = TorchMapper(index, K, W, batch_bases=16384, devices=["cpu"] * 2,
                     index_sharding="hash", idx_shards=2)
    with pytest.raises(RuntimeError, match="capture refused"):
        _raws(tm, reads + reads)
    contigs = _contigs(9)
    join = port.make_sharded_index_join(
        port.make_mesh_2d(2, ["cpu:0", "cpu:1"]),
        port.ShardedDeviceIndex.from_contig_index(_index(contigs), 2), K, W,
        max_anchors=SLOTS)
    codes, _, lengths, _ = _batches(contigs, 1, "plain", seed=5)[0]
    join(codes, lengths)
    with pytest.raises(RuntimeError, match="capture refused"):
        join(codes, lengths)


def test_grid_steps_eager_on_the_cpu():
    """Without a stand-in a CPU grid has no graph set: its steps run
    eagerly, and the mapper's summary says so."""
    index, reads = _dataset()
    tm = TorchMapper(index, K, W, batch_bases=16384, devices=["cpu"] * 2,
                     index_sharding="hash", idx_shards=2)
    _raws(tm, reads[:20])
    assert tm._hash_steps
    assert all(g is None for s in tm._hash_steps.values() for g in s.graphs)
    assert tm.graph_counts() is None


def test_a_mapper_made_under_a_profile_keeps_its_grids_eager(counted,
                                                            stand_in_sets,
                                                            monkeypatch):
    """A grid is made at its pad's first batch, but whether it replays
    graphs is decided when the mapper is made, as a replica's is: a mapper
    made while a profile may be taken runs its grids eagerly after the
    profile's switch is off; one made without replays them."""
    index, reads = _dataset()
    kw = dict(batch_bases=16384, devices=["cpu"] * 2, index_sharding="hash",
              idx_shards=2)
    monkeypatch.setenv("NTLINK_TORCH_PROFILE", "/nonexistent")
    profiled = TorchMapper(index, K, W, **kw)
    monkeypatch.delenv("NTLINK_TORCH_PROFILE")
    graphed = TorchMapper(index, K, W, **kw)
    for tm in (profiled, graphed):
        _raws(tm, reads + reads)
    assert profiled.graph_counts() is None
    assert all(g is None for s in profiled._hash_steps.values()
               for g in s.graphs)
    assert graphed.graph_counts()[1] > 0
