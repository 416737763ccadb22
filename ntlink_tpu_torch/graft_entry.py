"""Integration entry points of the port.

Counterpart of the repository's root ``__graft_entry__.py`` and of
``ntlink_tpu.parallel.mesh.dryrun``:

entry(): the one-device forward step of the flagship compute path, the
fused unpack + minimizer-sketch + hash-table-join `mapping_step` over a
2-bit-packed read batch, with example tensors (B=8, L=4096, k=32, w=100).

dryrun_multichip(n): one step of the data-parallel mapping path over n
devices (read batch split into row blocks, contig index replicated) in
each payload kind, then the hash-sharded-index step when n splits.

dryrun_sharded_index(n): one step of the hash-sharded-index path on a
(n / 2, 2) grid.

`devices` defaults to the first n visible CUDA devices; a list may name
one device several times (one card twice, ``["cpu"] * n``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import device as device_mod
from .chain import RUN_LANES
from .device_map import Replica
from .mapping_step import DeviceIndex, mapping_step, pack_codes
from .ops import nthash_np
from .parallel.sharded_index import (
    ShardedDeviceIndex, make_mesh_2d, make_sharded_index_mapping_step,
)
from .stream_pipeline import copy_back


def _synthetic(B: int, L: int, k: int, w: int):
    """A random batch and the index entries of row 0's own sketch: (codes,
    lengths, mins, (hashes, contig_ids, positions, strands))."""
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lengths = np.full(B, L, dtype=np.int32)
    mins = nthash_np.sketch_codes(codes[0], k, w)
    entries = (mins.hashes, np.zeros(len(mins), dtype=np.int32),
               mins.positions.astype(np.int32), mins.forward)
    return codes, lengths, mins, entries


def _devices(n_devices: int, devices):
    devs = device_mod.resolve_all(devices=devices)[:n_devices]
    if len(devs) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devs)}")
    return devs


def entry(device=None):
    """(fn, example_args): fn(packed, lengths, t_bkt) is the one-device
    mapping step with 256 anchor slots; the example tensors live on
    `device` (default: the card)."""
    k, w = 32, 100
    B, L = 8, 4096
    dev = device_mod.resolve(device)
    codes, lengths, _, entries = _synthetic(B, L, k, w)
    t_bkt, mask, probes = DeviceIndex.build_table(*entries)
    didx = DeviceIndex.from_numpy(t_bkt, mask, probes, device=dev)

    def fn(packed, lengths, t_bkt):
        return mapping_step(packed, lengths, DeviceIndex(t_bkt, mask, probes),
                            k, w, L, 256)

    example_args = (
        torch.from_numpy(pack_codes(codes)).to(dev),
        torch.from_numpy(lengths).to(dev),
        didx.t_bkt,
    )
    return fn, example_args


def dryrun(n_devices: int, k: int = 32, w: int = 100, devices=None) -> None:
    """One data-parallel mapping step over `n_devices` devices on a tiny
    synthetic batch, through `TorchMapper`'s replicas, with the assertions
    of ``mesh.dryrun``."""
    devs = _devices(n_devices, devices)
    B, L, slots = n_devices * 2, 2048, 256
    codes, lengths, mins, entries = _synthetic(B, L, k, w)
    table = DeviceIndex.build_table(*entries)
    clen = np.full(1, L, np.int32)
    replicas = [
        Replica(dev, DeviceIndex.from_numpy(*table, device=dev),
                 torch.from_numpy(clen).to(dev), own_stream=n_devices > 1)
        for dev in devs
    ]
    bounds = [B * d // n_devices for d in range(n_devices + 1)]

    def step(packed, nmask=None, chain=False, runs=False):
        """One batch over the replicas: [(a block's payload on the host,
        the block's rows)], in row order."""
        started = []
        for rep, lo, hi in zip(replicas, bounds, bounds[1:]):
            on = lambda a: torch.from_numpy(a[lo:hi]).to(rep.device)
            with rep.work():
                out = mapping_step(
                    on(packed), on(lengths), rep.didx, k, w, L, slots,
                    nmask=None if nmask is None else on(nmask),
                    clen=rep.clen if chain else None, z=1, runs=runs,
                )
                started.append((*copy_back(out), hi - lo))
        outs = []
        for host, event, b in started:
            if event is not None:
                event.synchronize()
            outs.append((host.numpy(), b))
        return outs

    def n_anchors(outs) -> int:
        return sum(int(flat[:b].sum()) for flat, b in outs)

    packed = pack_codes(codes)
    assert n_anchors(step(packed)) >= len(mins), "split join lost anchors"

    # N-batch variant: plant an N run in every row; the windows over the
    # valid k-mers must still find the anchors outside the gap
    bad = np.zeros((B, L), dtype=bool)
    bad[:, 700:760] = True
    codes_n = np.where(bad, 0, codes).astype(np.uint8)
    nmask = np.packbits(bad, axis=1, bitorder="little")
    assert n_anchors(step(pack_codes(codes_n), nmask)) > 0, \
        "split N join found no anchors"

    # on-device chaining variant: every anchor maps cleanly to the one
    # long contig, so chaining must accept them all
    assert n_anchors(step(packed, chain=True)) > 0, \
        "chained split step lost anchors"

    # runs-only variant (O(runs) payload): only row 0 matches the
    # synthetic index, so it must report exactly one merged run, and no
    # row may flag overflow
    runs = step(packed, chain=True, runs=True)
    counts = np.concatenate([flat[:b] for flat, b in runs])
    over = np.concatenate([flat[b : 2 * b] for flat, b in runs])
    assert counts[0] == 1, counts
    assert (over == 0).all(), over
    assert all(flat.shape[0] == 2 * b + 6 * b * RUN_LANES for flat, b in runs)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The engine's multi-device steps on `n_devices` devices: the
    data-parallel mapping step (index replicated) and, when the devices
    split, the (data, idx) hash-sharded-index step."""
    dryrun(n_devices, devices=devices)
    if n_devices >= 2:
        dryrun_sharded_index(n_devices, devices=devices)


def dryrun_sharded_index(n_devices: int, k: int = 32, w: int = 100,
                         devices=None) -> None:
    """One step of the hash-sharded-index mapping path on a (n / 2, 2)
    grid."""
    idx_shards = 2
    devs = _devices(n_devices, devices)
    data = n_devices // idx_shards
    B, L = max(2, data * 2), 2048
    codes, lengths, mins, entries = _synthetic(B, L, k, w)
    sidx = ShardedDeviceIndex(*entries, n_shards=idx_shards)
    mesh = make_mesh_2d(idx_shards, devs)
    step = make_sharded_index_mapping_step(mesh, sidx, k, w, L, 256)
    out = step(torch.from_numpy(pack_codes(codes)),
               torch.from_numpy(lengths))
    assert int(out["n_anchors"]) >= len(mins), \
        "sharded-index join lost anchors"
