"""The port's hash-sharded index (`parallel.sharded_index`) against
ntlink_tpu's: the host-built tables and `max_probes` for 1, 2 and 4
shards, the join on a (2, 4) grid against `make_sharded_index_join` on the
(2, 4) virtual CPU mesh and against the host index, the mapping step's
``{flat, n_anchors}`` payload against the JAX step's (plain, N batch,
hash planes), `pair` with index_sharding=hash byte-identical to replicated
with and without repeats, the one-device fallback, and the dryruns. The
grids name ``"cpu"`` once per cell. All comparisons are exact."""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ntlink_tpu.index import ContigIndex
from ntlink_tpu.ops import nthash_np
from ntlink_tpu.parallel import sharded_index as ref
from ntlink_tpu.parallel.mesh import pack_codes
from ntlink_tpu_torch import graft_entry, pipeline
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.parallel import sharded_index as port

from .synthetic import write_dataset

K, W = 32, 100


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    contigs = [rng.integers(0, 4, 20000).astype(np.uint8) for _ in range(3)]
    index = ContigIndex.from_sketches(
        (f"c{i}", nthash_np.sketch_codes(c, K, W))
        for i, c in enumerate(contigs)
    )
    # reads: slices of contigs (hits) and one half contig, half random
    B, L = 4, 8192
    codes = np.zeros((B, L), np.uint8)
    for r in range(B - 1):
        codes[r] = contigs[r % 3][1000 * r : 1000 * r + L]
    codes[B - 1, : L // 2] = contigs[0][: L // 2]
    codes[B - 1, L // 2 :] = rng.integers(0, 4, L - L // 2)
    return index, codes, np.full(B, L, np.int32)


def _mesh(n_data=2, n_idx=4):
    assert len(jax.devices()) == 8
    return Mesh(np.array(jax.devices()[: n_data * n_idx]).reshape(
        n_data, n_idx), ("data", "idx"))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_tables_equal_the_jax_package(data, n_shards):
    index = data[0]
    a = port.ShardedDeviceIndex.from_contig_index(index, n_shards)
    b = ref.ShardedDeviceIndex.from_contig_index(index, n_shards)
    assert (a.size, a.mask, a.max_probes) == (b.size, b.mask, b.max_probes)
    assert a.t_rows.dtype == np.uint32
    assert np.array_equal(a.t_rows, b.t_rows)
    assert np.array_equal(a.host_offsets, b.host_offsets)
    assert a.pack_gpos == b.pack_gpos
    assert np.array_equal(a.t_off, np.asarray(b.t_off))
    g = np.arange(0, int(a.host_offsets[-1]), 997, dtype=np.uint32).view(
        np.int32)
    for x, y in zip(a.decode_gpos(g), b.decode_gpos(g)):
        assert np.array_equal(x, y)


def test_join_matches_the_jax_join_and_the_host_index(data):
    index, codes, lengths = data
    sidx = port.ShardedDeviceIndex.from_contig_index(index, 4)
    join = port.make_sharded_index_join(
        port.make_mesh_2d(4, ["cpu"] * 8), sidx, K, W, max_anchors=512)
    count, anchors = join(codes, lengths)
    count, anchors = count.numpy(), anchors.numpy()
    assert count.dtype == anchors.dtype == np.int32
    r_count, r_anchors = ref.make_sharded_index_join(
        _mesh(), ref.ShardedDeviceIndex.from_contig_index(index, 4), K, W,
        max_anchors=512)(codes, lengths)
    assert np.array_equal(count, np.asarray(r_count))
    assert np.array_equal(anchors, np.asarray(r_anchors))
    assert count.sum() > 100
    for r in range(len(codes)):
        mins = nthash_np.sketch_codes(codes[r], K, W)
        found, cid, cpos, cstrand = index.lookup_many(mins.hashes)
        n = int(count[r])
        assert n == int(found.sum())
        assert np.array_equal(anchors[r, 0, :n], mins.positions[found])
        assert np.array_equal(anchors[r, 1, :n], cid[found])
        assert np.array_equal(anchors[r, 2, :n], cpos[found])
        bits = cstrand[found].astype(np.int32) | (
            mins.forward[found].astype(np.int32) << 1)
        assert np.array_equal(anchors[r, 3, :n], bits)


@pytest.mark.parametrize("variant", ["plain", "hashes", "n-batch"])
def test_mapping_step_payload_matches_the_jax_step(data, variant):
    """{flat, n_anchors}: meta in flat row 0 and every plane's found
    prefix, on (2, 2) and (1, 4) grids."""
    index, codes, lengths = data
    B, L = codes.shape
    with_hashes = variant == "hashes"
    nmask = None
    if variant == "n-batch":
        bad = np.zeros((B, L), bool)
        bad[:, 3000:3040] = True
        bad[1, 0] = bad[2, L - 1] = True
        codes = np.where(bad, 0, codes).astype(np.uint8)
        nmask = np.packbits(bad, axis=1, bitorder="little")
    packed = pack_codes(codes)
    for n_data, n_idx in ((2, 2), (1, 4)):
        sidx = port.ShardedDeviceIndex.from_contig_index(index, n_idx)
        step = port.make_sharded_index_mapping_step(
            port.make_mesh_2d(n_idx, ["cpu"] * (n_data * n_idx)), sidx, K, W,
            L, 256, with_hashes=with_hashes)
        out = step(torch.from_numpy(packed), torch.from_numpy(lengths),
                   nmask=None if nmask is None else torch.from_numpy(nmask))
        r_step = ref.make_sharded_index_mapping_step(
            _mesh(n_data, n_idx),
            ref.ShardedDeviceIndex.from_contig_index(index, n_idx), K, W, L,
            256, with_hashes=with_hashes)
        r_out = r_step(jnp.asarray(packed), jnp.asarray(lengths),
                       nmask=None if nmask is None else jnp.asarray(nmask))
        flat, r_flat = out["flat"].numpy(), np.asarray(r_out["flat"])
        n = int(out["n_anchors"])
        assert n == int(r_out["n_anchors"]) > 100
        assert flat.dtype == r_flat.dtype == np.int32
        assert flat.shape == r_flat.shape == (
            1 + 2 + 2 * with_hashes, B * 256)
        assert np.array_equal(flat[0], r_flat[0])           # meta row
        assert int(flat[0, :B].sum()) == n
        assert np.array_equal(flat[1:, :n], r_flat[1:, :n])


def _pair(d, **kw):
    cfg = ScaffoldConfig(target="target.fa", reads=["reads.fa"], k=32, w=100,
                         z=1000, t=1, pairs_tsv=True, batch_bases=200_000,
                         **kw)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        pipeline.pair_stage(cfg, device=["cpu"] * 4)
    finally:
        os.chdir(cwd)
    return pipeline.last_mapper


@pytest.mark.parametrize("repeats", [False, True])
def test_pair_hash_sharded_matches_replicated(tmp_path, repeats):
    mappers = {}
    for sharding in ("replicated", "hash"):
        write_dataset(tmp_path / sharding, seed=61, n_reads=80)
        mappers[sharding] = _pair(tmp_path / sharding, repeats=repeats,
                                  index_sharding=sharding, idx_shards=2)
    tm = mappers["hash"]
    assert tm.index_sharding == "hash" and tm.idx_shards == 2
    assert not tm.prechained and not tm.runs_only  # hash chains on the host
    assert "hash-sharded over a 2 x 2 (data, idx) grid" in tm.layout()
    assert mappers["replicated"].prechained == (not repeats)
    assert tm.device_reads > 70
    prefix = "target.fa.k32.w100.z1000"
    for artifact in (".verbose_mapping.tsv", ".pairs.tsv", ".n1.scaffold.dot"):
        a = tmp_path / "replicated" / (prefix + artifact)
        assert os.path.getsize(a) > 0
        assert filecmp.cmp(a, tmp_path / "hash" / (prefix + artifact),
                           shallow=False), artifact


def test_one_device_falls_back_to_replicated(data, capsys):
    """``DeviceMapper``'s rule (device_map.py:94-95): nothing to shard
    over, so the mapper runs replicated and its summary line says so."""
    index, codes, _ = data
    tm = TorchMapper(index, K, W, device="cpu", index_sharding="hash",
                     idx_shards=2)
    assert tm.index_sharding == "replicated" and tm.n_devices == 1
    got = list(tm.map_stream_raw(iter([("r0", codes[0])])))
    assert got[0][2][0] > 50
    assert "cpu, index replicated" in capsys.readouterr().err


def test_default_idx_shards_split_the_devices(data):
    tm = TorchMapper(data[0], K, W, devices=["cpu"] * 6,
                     index_sharding="hash")
    assert tm.idx_shards == 2 and len(tm._mesh2d) == 3


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip(n):
    graft_entry.dryrun_multichip(n, devices=["cpu"] * n)


def test_dryrun_sharded_index_and_entry():
    graft_entry.dryrun_sharded_index(8, devices=["cpu"] * 8)
    fn, args = graft_entry.entry("cpu")
    assert tuple(args[0].shape) == (8, 1024) and tuple(args[1].shape) == (8,)
    out = fn(*args)
    # the root entry point's step on the same example arguments
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "graft_entry_ref", os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    r_fn, r_args = mod.entry()
    assert np.array_equal(args[0].numpy(), np.asarray(r_args[0]))
    r_out = r_fn(*r_args)
    B = 8
    r_meta = np.asarray(r_out["flat"])[0, : 2 * B]
    assert np.array_equal(out[: 2 * B].numpy(), r_meta)
    assert int(out[:B].sum()) == int(r_out["n_anchors"]) > 0
