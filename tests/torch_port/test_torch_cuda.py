"""The Hopper sketch kernel and integer peak probe against their plain
versions, and the steps of N batches against the CPU's, on the card.

This file imports no JAX (nor does anything it imports), so it also runs on
a machine without JAX, where ``tests/conftest.py`` cannot load:

    python3 -m pytest --noconftest -q tests/torch_port/test_torch_cuda.py

Without a CUDA device every test here skips.
"""
import numpy as np
import pytest
import torch

from ntlink_tpu_torch.ops import alu_peak_cuda, sketch_cuda, sketch_torch as st
from ntlink_tpu_torch.ops.alu_peak_torch import WIDTHS, alu_peak_ref


def _edge_lengths(rng, k, w, B, L):
    """B row lengths, the first of them at the edges: no window, no k-mer,
    empty, one window, the full pad."""
    lengths = rng.integers(L // 2, L + 1, size=max(B, 5)).astype(np.int32)
    lengths[:5] = [k + w - 2, k - 1, 0, k + w - 1, L]
    return lengths[:B]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,w,L", [(32, 100, 16384), (15, 5, 32768), (40, 100, 1 << 21),
              (24, 250, 5000)]
)
def test_kernel_matches_plain_version_on_card(k, w, L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(L + k)
    B = 16 if L <= 32768 else 8
    codes = torch.from_numpy(rng.integers(0, 4, (B, L), dtype=np.uint8))
    lengths = torch.from_numpy(_edge_lengths(rng, k, w, B, L))
    codes, lengths = codes.cuda(), lengths.cuda()
    launches = sketch_cuda.launches
    can, fwd, winner, emit = sketch_cuda.sketch_rows(codes, lengths, k, w)
    assert sketch_cuda.launches == launches + 1
    r_can, r_fwd, r_win, r_emit = st.sketch_rows_ref(codes, lengths, k, w)
    torch.cuda.synchronize()
    valid = (
        torch.arange(L, device=codes.device)[None, :]
        <= (lengths.long() - k)[:, None]
    )
    assert torch.equal(can[valid], r_can[valid])
    assert torch.equal(fwd[valid], r_fwd[valid])
    assert torch.equal(winner, r_win)
    assert torch.equal(emit, r_emit)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sketch", "anchors", "runs"])
def test_steps_with_n_rows_on_card_match_cpu(mode):
    """The sketch step and the mapping step (chained, per-anchor and
    runs) on an N batch: the card's payload equals the CPU's (plain
    version) bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ntlink_tpu_torch import mapping_step as ms
    from ntlink_tpu_torch.index import ContigIndex
    from ntlink_tpu_torch.ops import nthash_np
    from ntlink_tpu_torch.stream_pipeline import split_n_rows

    k, w, L, B = 32, 100, 16384, 16
    rng = np.random.default_rng(7)
    contigs = [rng.integers(0, 4, 200_000).astype(np.uint8) for _ in range(3)]
    rows, lengths = [], _edge_lengths(rng, k, w, B, L)
    for r in range(B):
        s = int(rng.integers(0, 200_000 - L))
        read = contigs[r % 3][s : s + int(lengths[r])].copy()
        if len(read):
            read[rng.integers(0, len(read), 3 * (r % 4))] = 4
        rows.append(read)
    clean, nmask = split_n_rows(rows, B, L)
    codes = np.zeros((B, L), np.uint8)
    for r, c in enumerate(clean):
        codes[r, : len(c)] = c
    args = [torch.from_numpy(ms.pack_codes(codes)),
            torch.from_numpy(lengths), torch.from_numpy(nmask)]
    outs = []
    for dev in ("cpu", "cuda"):
        packed, lens, nm = (a.to(dev) for a in args)
        if mode == "sketch":
            out = ms.sketch_step(packed, lens, k, w, L, 1024, nmask=nm)
        else:
            index = ContigIndex.from_sketches(
                (f"c{i}", nthash_np.sketch_codes(c, k, w))
                for i, c in enumerate(contigs)
            )
            out = ms.mapping_step(
                packed, lens, ms.DeviceIndex.from_contig_index(index, dev),
                k, w, L, 1024, nmask=nm,
                clen=torch.full((3,), 200_000, dtype=torch.int32,
                                device=dev),
                z=1000, runs=mode == "runs",
            )
        outs.append(out.cpu())
    assert torch.equal(outs[0], outs[1])
    assert int(outs[0][:B].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDTHS)
def test_alu_peak_matches_plain_version_on_card(width):
    """The probe kernel equals its plain version bit for bit (uint32 math
    mod 2^32) at the probe's (256, 1024) shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(width)
    x = rng.integers(0, 2**32, (256, 1024), dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(x.view(np.int32)).cuda()
    for iters in (0, 1, 7, 64):
        launches = alu_peak_cuda.launches
        out = alu_peak_cuda.alu_peak(x, iters, width)
        assert alu_peak_cuda.launches == launches + 1
        assert torch.equal(out, alu_peak_ref(x, iters, width)), iters


def _mapper_case():
    """A small index and reads that hit it (some with an N), from a seed."""
    from ntlink_tpu_torch.index import ContigIndex
    from ntlink_tpu_torch.ops import nthash_np

    k, w = 32, 100
    rng = np.random.default_rng(77)
    contigs = [rng.integers(0, 4, 120_000).astype(np.uint8) for _ in range(3)]
    index = ContigIndex.from_sketches(
        (f"c{i}", nthash_np.sketch_codes(c, k, w))
        for i, c in enumerate(contigs)
    )
    reads = []
    for r, n in enumerate([20, 900, 1024, 3000, 5000, 16384, 20000, 40000]
                          * 6):
        c = contigs[r % 3]
        s = int(rng.integers(0, len(c) - n))
        read = c[s : s + n].copy()
        if r % 5 == 0 and n > 100:
            read[n // 2] = 4
        reads.append((f"r{r}", read))
    return index, reads, k, w


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prechained", "runs", "hashes", "hash"])
def test_card_named_twice_matches_one_device(kind):
    """``devices=["cuda:0", "cuda:0"]`` (two replicas on their own streams,
    or a 1 x 2 hash-sharded grid) yields the one-device payloads, and
    every replica launches the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ntlink_tpu_torch.device_map import TorchMapper

    index, reads, k, w = _mapper_case()
    prechain = (np.full(3, 120_000, np.int32), 1000)
    kw = {
        "prechained": dict(prechain=prechain),
        "runs": dict(prechain=prechain, runs_only=True),
        "hashes": dict(with_hashes=True),
        "hash": dict(with_hashes=True, index_sharding="hash", idx_shards=2),
    }[kind]
    one_kw = {a: b for a, b in kw.items()
              if a not in ("index_sharding", "idx_shards")}
    one = TorchMapper(index, k, w, batch_bases=262_144, device="cuda:0",
                      **one_kw)
    two = TorchMapper(index, k, w, batch_bases=262_144,
                      devices=["cuda:0", "cuda:0"], **kw)
    want = list(one.map_stream_raw(iter(reads)))
    got = list(two.map_stream_raw(iter(reads)))
    assert len(got) == len(want) == len(reads)
    n_hits = 0
    for a, b in zip(got, want):
        assert a[:2] == b[:2]
        assert (a[2] is None) == (b[2] is None), a[0]
        if a[2] is None:
            continue
        n_hits += 1
        assert a[2][0] == b[2][0], a[0]
        for x, y in zip(a[2][1:], b[2][1:]):
            assert np.array_equal(x[: a[2][0]], y[: b[2][0]]), a[0]
    assert n_hits > 30
    assert min(two.launches_by_device()) > 0
    assert two.kernel_launches >= one.kernel_launches


@pytest.mark.cuda
@pytest.mark.parametrize("load4", [False, True])
def test_bounded_scale_run_on_the_card(tmp_path, monkeypatch, load4):
    """`scale.bounded_run` on the card at a small size, with the bucket
    table in each load regime: the table read back from the card equals
    the host's, and every read's payload equals the native host path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ntlink_tpu_torch import mapping_step, scale

    if load4:
        monkeypatch.setattr(mapping_step, "SMALL_TABLE_ENTRIES", 1_000)
    d = str(tmp_path / "scale")
    scale.write_stress_dataset(d, 4, 2_500_000, 300)
    out = scale.bounded_run(d, 300, device="cuda", check_reads=300,
                            log=lambda *a: None)
    assert out["table"]["regime"] == ("load-4" if load4 else "load-2")
    assert out["table_equal"] and out["payloads_equal"]
    assert out["payloads_checked"] == 300
    assert out["sketch"]["chunked"] == 4 and out["sketch"]["launches"] > 0
    assert out["mapping"]["launches"] > 0
    assert out["mapping"]["peak_device_mib"] > 0


GRAPH_KINDS = ("sketch", "no chain", "hash planes", "anchors", "runs-only")


def _graph_call(kind, pad, has_n, B, seed, dev):
    """One step of `kind` on three (B, pad) batches of reads cut from three
    indexed contigs (with N when `has_n`): (step, [host batch dicts],
    static arguments on `dev`)."""
    from ntlink_tpu_torch import mapping_step as ms
    from ntlink_tpu_torch.stream_pipeline import pack_batch, pinned
    from ntlink_tpu_torch.index import ContigIndex
    from ntlink_tpu_torch.ops import nthash_np

    k, w = 32, 100
    rng = np.random.default_rng(seed)
    size = max(3 * pad, 60_000)
    contigs = [rng.integers(0, 4, size).astype(np.uint8) for _ in range(3)]
    batches = []
    for _ in range(3):
        rows = []
        for r in range(B - 1):  # a padding row at the end
            n = int(rng.integers(pad // 2, pad + 1))
            s = int(rng.integers(0, size - n))
            read = contigs[r % 3][s : s + n].copy()
            if has_n and r % 3 == 0:
                read[rng.integers(0, n, 4)] = 4
            rows.append(read)
        lengths = np.zeros(B, np.int32)
        lengths[: len(rows)] = [len(c) for c in rows]
        packed, nmask = pack_batch(rows, B, pad, has_n)
        p, ln, nm = pinned(dev, packed, lengths, nmask)
        batches.append(dict(packed=p, lengths=ln, nmask=nm))
    if kind == "sketch":
        return ms.sketch_step, batches, dict(k=k, w=w, L=pad, max_mins=1024)
    index = ContigIndex.from_sketches(
        (f"c{i}", nthash_np.sketch_codes(c, k, w))
        for i, c in enumerate(contigs))
    chain = kind in ("anchors", "runs-only")
    static = dict(
        index=ms.DeviceIndex.from_contig_index(index, dev), k=k, w=w, L=pad,
        slots=1024, z=1000, runs=kind == "runs-only",
        with_hashes=kind == "hash planes",
        clen=torch.full((3,), size, dtype=torch.int32, device=dev)
        if chain else None)
    return ms.mapping_step, batches, static


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GRAPH_KINDS)
@pytest.mark.parametrize("pad,has_n", [(1024, True), (16384, False),
                                       (16384, True), (1 << 21, False)])
def test_step_graph_replays_equal_eager_on_card(kind, pad, has_n):
    """A step graph captured on one batch and replayed on two others: each
    payload equals the eager step's on its own batch, byte for byte, and
    the kernel is counted once per batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ntlink_tpu_torch.stream_pipeline import copy_back
    from ntlink_tpu_torch.step_graph import StepGraphs

    dev = torch.device("cuda", 0)
    B = 2 if pad == 1 << 21 else 8
    step, batches, static = _graph_call(kind, pad, has_n, B, pad + B, dev)
    g = StepGraphs(dev)
    launches = sketch_cuda.launches
    held = []
    for batch in batches:
        host, event = copy_back(g.run(step, batch, static))
        held.append((host, event))
    assert sketch_cuda.launches - launches == len(batches)
    assert (g.captures, g.replays) == (1, len(batches) - 1)
    for (host, event), batch in zip(held, batches):
        event.synchronize()
        inputs = {n: None if t is None else t.to(dev)
                  for n, t in batch.items()}
        want = step(**inputs, **static).cpu()
        assert torch.equal(host, want)
    assert int(held[-1][0][:B].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prechained", "runs", "hashes", "sketch"])
def test_streams_with_graphs_equal_eager_on_card(monkeypatch, kind):
    """TorchMapper and TorchSketcher on the card replay their graphs; the
    same streams under NTLINK_TORCH_PROFILE run the steps eagerly; every
    payload is the same and the kernel launches equal device batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ntlink_tpu_torch.device_map import TorchMapper
    from ntlink_tpu_torch.sketch import TorchSketcher

    index, reads, k, w = _mapper_case()
    reads = reads * 2
    kw = {
        "prechained": dict(prechain=(np.full(3, 120_000, np.int32), 1000)),
        "runs": dict(prechain=(np.full(3, 120_000, np.int32), 1000),
                     runs_only=True),
        "hashes": dict(with_hashes=True),
        "sketch": None,
    }[kind]
    outs = []
    for eager in (False, True):
        if eager:
            monkeypatch.setenv("NTLINK_TORCH_PROFILE", "/nonexistent")
        launches = sketch_cuda.launches
        if kw is None:
            s = TorchSketcher("cuda:0", batch_bases=262_144)
            got = [(n, ln, m.hashes, m.positions, m.forward) for n, ln, m
                   in s.sketch_stream(iter(reads), k, w)]
            graphs, batches = s.graphs, sum(s.batches_by_pad.values())
        else:
            m = TorchMapper(index, k, w, batch_bases=262_144,
                            device="cuda:0", **kw)
            got = list(m.map_stream_raw(iter(reads)))
            graphs = m._replicas[0].graphs
            batches = sum(m.batches_by_pad.values())
        assert sketch_cuda.launches - launches == batches
        if eager:
            assert graphs is None
        else:
            assert graphs.replays > 0
            assert graphs.warm_ups + graphs.replays == batches
        outs.append(got)
    assert len(outs[0]) == len(outs[1]) == len(reads)
    for a, b in zip(*outs):
        assert a[:2] == b[:2]
        if kw is None:
            for x, y in zip(a[2:], b[2:]):
                assert np.array_equal(x, y), a[0]
            continue
        assert (a[2] is None) == (b[2] is None), a[0]
        if a[2] is not None:
            for x, y in zip(a[2][1:], b[2][1:]):
                assert np.array_equal(x, y), a[0]


@pytest.mark.cuda
def test_a_capture_that_fails_raises_on_card():
    """A step that waits on the card cannot be captured: the capture
    raises, nothing runs eagerly in its place, and the card works on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ntlink_tpu_torch.step_graph import StepGraphs

    def syncing_step(packed, lengths, nmask):
        return lengths * int(packed.sum().item())

    dev = torch.device("cuda", 0)
    g = StepGraphs(dev)
    batch = dict(packed=torch.ones(4, 8, dtype=torch.uint8).pin_memory(),
                 lengths=torch.ones(4, dtype=torch.int32).pin_memory(),
                 nmask=None)
    g.run(syncing_step, batch, {})  # the first batch runs eagerly
    with pytest.raises(RuntimeError):
        g.run(syncing_step, batch, {})
    assert (g.warm_ups, g.captures) == (1, 0)
    x = torch.arange(10, device=dev)
    assert int(x.sum()) == 45


@pytest.mark.cuda
def test_a_graph_freed_during_another_capture_on_card():
    """The garbage collector may free a finished stream's graph sets at any
    allocation, even in the middle of another set's capture: the capture
    goes on, and both sets' replays stay right."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ntlink_tpu_torch.step_graph import StepGraphs

    dev = torch.device("cuda", 0)

    def batch(v):
        return dict(packed=torch.full((4, 8), v, dtype=torch.uint8)
                    .pin_memory(),
                    lengths=torch.full((4,), v, dtype=torch.int32)
                    .pin_memory(),
                    nmask=None)

    def doubling(packed, lengths, nmask):
        return lengths * 2 + packed.sum(dim=1, dtype=torch.int32)

    old = StepGraphs(dev)
    for v in (1, 2):
        old.run(doubling, batch(v), {})
    held = [old]
    del old

    def dropping(packed, lengths, nmask):
        if torch.cuda.is_current_stream_capturing():
            held.clear()  # the old set's graph is destroyed here
        return lengths * 3

    g = StepGraphs(dev)
    outs = [g.run(dropping, batch(v), {}).cpu() for v in (1, 5, 7)]
    assert not held and (g.captures, g.replays) == (1, 2)
    assert [o.tolist() for o in outs] == [[3] * 4, [15] * 4, [21] * 4]


@pytest.mark.cuda
@pytest.mark.parametrize("repeats", [False, True])
def test_hash_grid_stream_with_graphs_equals_eager_on_card(monkeypatch,
                                                          repeats):
    """``index_sharding=hash`` on the card named twice (a 1 x 2 grid on
    one device) replays one graph per batch after each key's first; the
    same stream under NTLINK_TORCH_PROFILE runs the grid's steps eagerly;
    every payload is the same, and the kernel launches equal device
    batches x idx ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ntlink_tpu_torch.device_map import TorchMapper

    index, reads, k, w = _mapper_case()
    reads = reads * 2
    outs = []
    for eager in (False, True):
        if eager:
            monkeypatch.setenv("NTLINK_TORCH_PROFILE", "/nonexistent")
        launches = sketch_cuda.launches
        m = TorchMapper(index, k, w, batch_bases=262_144,
                        devices=["cuda:0", "cuda:0"], with_hashes=repeats,
                        index_sharding="hash", idx_shards=2)
        outs.append(list(m.map_stream_raw(iter(reads))))
        batches = sum(m.batches_by_pad.values())
        assert sketch_cuda.launches - launches == 2 * batches
        counts = m.graph_counts()
        if eager:
            assert counts is None
        else:
            captures, replays, _, first = counts
            assert captures > 0 and replays > 0
            assert first + replays == batches
            assert all(len(s.graphs) == 1 for s in m._hash_steps.values())
    assert len(outs[0]) == len(outs[1]) == len(reads)
    n_hits = 0
    for a, b in zip(*outs):
        assert a[:2] == b[:2]
        assert (a[2] is None) == (b[2] is None), a[0]
        if a[2] is not None:
            n_hits += 1
            for x, y in zip(a[2][1:], b[2][1:]):
                assert np.array_equal(x, y), a[0]
    assert n_hits > 30


@pytest.mark.cuda
def test_hash_grid_join_graphs_equal_eager_on_card(monkeypatch):
    """`make_sharded_index_join` on the card named twice: its first call
    runs the grid's step eagerly, the second captures it, the third
    replays; each (count, anchors) equals the eager join's (under
    NTLINK_TORCH_PROFILE) on the same codes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ntlink_tpu_torch.parallel import sharded_index as si

    index, reads, k, w = _mapper_case()
    sidx = si.ShardedDeviceIndex.from_contig_index(index, 2)
    grid = si.make_mesh_2d(2, ["cuda:0", "cuda:0"])
    join = si.make_sharded_index_join(grid, sidx, k, w, max_anchors=512)
    eager = si.make_sharded_index_join(grid, sidx, k, w, max_anchors=512)
    long = [r for _, r in reads if len(r) == 3000]
    for i in range(3):
        codes = np.zeros((4, 4096), np.uint8)
        lengths = np.zeros(4, np.int32)
        for r in range(4):
            read = long[(4 * i + r) % len(long)]
            codes[r, : len(read)] = np.minimum(read, 3)
            lengths[r] = len(read)
        launches = sketch_cuda.launches
        count, anchors = (t.cpu() for t in join(codes, lengths))
        assert sketch_cuda.launches - launches == 2
        # its grid is made at its first call, with no graph set there
        monkeypatch.setenv("NTLINK_TORCH_PROFILE", "/nonexistent")
        r_count, r_anchors = (t.cpu() for t in eager(codes, lengths))
        monkeypatch.delenv("NTLINK_TORCH_PROFILE")
        assert torch.equal(count, r_count) and int(count.sum()) > 0
        assert torch.equal(anchors, r_anchors)
    ((_, graphs),) = join.grids.values()
    ((_, none),) = eager.grids.values()
    assert none == [None]
    assert (graphs[0].warm_ups, graphs[0].captures, graphs[0].replays) == (
        1, 1, 2)
