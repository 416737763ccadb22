"""TorchMapper over several devices (index replicated on each, a batch's
rows split into contiguous blocks) against the same mapper on one device
and against ntlink_tpu's DeviceMapper on the 8-device virtual CPU mesh:
every read's raw payload is equal, in every payload kind (per-anchor
host-chained, with hash planes, prechained, runs-only), N rows, sub-k
rows, a slot-overflow row and a run-lane-overflow row included. The
devices are ``["cpu"] * n``: one device named n times, which is how the
split and the join are reached where there is one device. All
comparisons are exact."""
import numpy as np
import pytest

from ntlink_tpu.device_map import DeviceMapper
from ntlink_tpu_torch.device_map import TorchMapper, default_idx_shards

from .test_torch_device_map import K, W, _chimera, _dataset, _raws

PRECHAIN = (np.full(3, 150_000, np.int32), 1000)
KINDS = {
    "host-chained": dict(),
    "hashes": dict(with_hashes=True),
    "prechained": dict(prechain=PRECHAIN),
    "runs-only": dict(prechain=PRECHAIN, runs_only=True),
}


def _mapper(index, kind, **kw):
    tm = TorchMapper(index, K, W, batch_bases=65536, **KINDS[kind], **kw)
    # the 16384-base read overflows a shrunk slot budget
    slots_for = tm._slots_for
    tm._slots_for = lambda L: 64 if L == 16384 else slots_for(L)
    return tm


def _same_raw(a, b, kind):
    """Every field of two raw tuples; the hash halves where the mapper
    ships them (without `with_hashes` only host-path rows carry them)."""
    assert a[:2] == b[:2]
    ra, rb = a[2], b[2]
    assert (ra is None) == (rb is None), a[0]
    if ra is None:
        return
    assert ra[0] == rb[0] and len(ra) == len(rb), a[0]
    fields = slice(1, None if kind in ("hashes", "runs-only") else 5)
    for x, y in zip(ra[fields], rb[fields]):
        assert np.array_equal(x[: ra[0]], y[: rb[0]]), a[0]


@pytest.fixture(scope="module")
def data():
    index, reads, contigs = _dataset(with_contigs=True)
    return index, reads + [("chimera", _chimera(contigs))]


@pytest.fixture(scope="module")
def one_device(data):
    index, reads = data
    out = {}
    for kind in KINDS:
        tm = _mapper(index, kind, device="cpu")
        out[kind] = (_raws(tm, reads), tm.host_fallbacks)
    return out


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("n", [2, 3, 4])
def test_several_devices_match_one_device(data, one_device, kind, n):
    index, reads = data
    tm = _mapper(index, kind, devices=["cpu"] * n)
    assert tm.n_devices == n and tm.index_sharding == "replicated"
    assert (tm.prechained, tm.runs_only) == (
        "prechain" in KINDS[kind], kind == "runs-only")
    got = _raws(tm, reads)
    want, fallbacks = one_device[kind]
    assert len(got) == len(want) == len(reads)
    for a, b in zip(got, want):
        _same_raw(a, b, kind)
    # overflow rows and sub-k reads keep their place and their path
    assert tm.host_fallbacks == fallbacks >= 3
    assert tm.device_reads == len(reads) - fallbacks
    assert any(has_n for _, has_n in tm.batches_by_pad)
    assert f"replicated on {n} devices" in tm.layout()


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_several_devices_match_device_mapper_on_the_mesh(data, kind):
    """DeviceMapper with use_mesh=True shards the same step over the eight
    virtual CPU devices. It keeps its own slot budget, so the 16384-base
    read stays on its device path while the port maps it again on the
    host: both are exact."""
    index, reads = data
    tm = _mapper(index, kind, devices=["cpu"] * 4)
    kw = dict(KINDS[kind])
    kw.setdefault("with_hashes", False)
    dm = DeviceMapper(index, K, W, batch_bases=65536, use_mesh=True, **kw)
    assert dm.n_devices == 8
    got, want = _raws(tm, reads), _raws(dm, reads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_raw(a, b, kind)
    assert sum(r[2] is not None for r in got) > 30


def test_every_replica_launches_and_blocks_keep_row_order(data):
    """With a step that records its blocks: a full batch gives every
    replica one block, blocks are contiguous and in order, and an
    all-padding block is skipped."""
    from ntlink_tpu_torch import device_map

    index, reads = data
    calls = []
    real = device_map.mapping_step

    def spy(packed, lengths, didx, *a, **kw):
        calls.append((id(didx), int(packed.shape[0]),
                      int((lengths > 0).sum())))
        return real(packed, lengths, didx, *a, **kw)

    tm = _mapper(index, "host-chained", devices=["cpu"] * 3)
    device_map.mapping_step, old = spy, device_map.mapping_step
    try:
        got = _raws(tm, reads)
    finally:
        device_map.mapping_step = old
    assert len(got) == len(reads)
    assert all(n_real > 0 for _, _, n_real in calls)
    assert len(calls) > sum(tm.batches_by_pad.values())
    assert len(tm._replicas) == 3
    # the three replicas share one table on the one device they name
    assert len({id(r.didx) for r in tm._replicas}) == 1


def test_default_idx_shards():
    assert [default_idx_shards(n) for n in (1, 2, 3, 4, 6, 8)] == [
        1, 2, 1, 4, 2, 4]
