"""The contig table's layout record (`mapping_step.TableLayout`) and the
read stream's bucket-join counts (`TorchMapper.join_stats`), in the load-4
regime that a human-size draft takes. The threshold is lowered for the
test only (an attribute set in both packages), and hashes are skewed onto
a few home buckets, so that spill chains run five or more buckets long.
Every comparison is exact: the layout against a recount from the table
and the table against ntlink_tpu.parallel.mesh's; the stream's verbose
mapping against HostMapper's, byte for byte, and its counts against a
recount from the step's own payloads. The counts are taken only while the
Tracer is on."""
import os

import numpy as np
import pytest

from ntlink_tpu.parallel import mesh
from ntlink_tpu_torch import device_map, pipeline, tracing
from ntlink_tpu_torch import mapping_step as ms
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.index import ContigIndex
from ntlink_tpu_torch.ops.nthash_np import Minimizers, sketch_codes

from .synthetic import write_dataset

K, W, Z = 32, 100, 1000
SMALL = 1_000
#: spill chains the skewed tables must reach
LONG_CHAIN = 5


@pytest.fixture
def load4(monkeypatch):
    monkeypatch.setattr(mesh, "SMALL_TABLE_ENTRIES", SMALL)
    monkeypatch.setattr(ms, "SMALL_TABLE_ENTRIES", SMALL)


def _home(hashes: np.ndarray, nb: int) -> np.ndarray:
    lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (hashes >> np.uint64(32)).astype(np.uint32)
    return (((lo ^ hi) * np.uint32(ms._FIB)).astype(np.uint32)
            & np.uint32(nb - 1)).astype(np.int64)


def _buckets_for(n: int, load: int) -> int:
    nb = 2
    while nb * load < n:
        nb <<= 1
    return nb


def _homed_on(hot: np.ndarray, nb: int, per_bucket: int, rng,
              avoid: np.ndarray) -> np.ndarray:
    """`per_bucket` random hashes homed on each bucket of `hot`, none of
    them in `avoid`."""
    pool = np.unique(rng.integers(1, 2**64 - 1, 4 * per_bucket * nb,
                                  dtype=np.uint64))
    pool = pool[~np.isin(pool, avoid)]
    home = _home(pool, nb)
    out = [pool[home == b][:per_bucket] for b in hot]
    assert all(len(x) == per_bucket for x in out)
    return np.concatenate(out)


def recount(t_bkt: np.ndarray, small: int) -> ms.TableLayout:
    """The layout read back from a table: entries are the occupied slots;
    an entry's chain runs from its home bucket to the bucket it sits in,
    and the longest chain is the insertion rounds, `max_probes`."""
    nb = t_bkt.shape[0]
    occupied = t_bkt[:, 2 * ms.BUCKET: 3 * ms.BUCKET] != 0
    hashes = (t_bkt[:, : ms.BUCKET].astype(np.uint64) << np.uint64(32)
              | t_bkt[:, ms.BUCKET: 2 * ms.BUCKET].astype(np.uint64))
    bucket = np.broadcast_to(np.arange(nb)[:, None], occupied.shape)
    dist = (bucket[occupied] - _home(hashes[occupied], nb)) % nb
    entries = int(occupied.sum())
    rounds = int(dist.max()) + 1 if entries else 0
    return ms.TableLayout(entries, nb, 4 if entries > small else 2,
                          max(rounds, 1))


@pytest.mark.parametrize("regime", ["load-4", "load-2"])
@pytest.mark.parametrize("seed", [41, 42])
def test_layout_record_equals_a_recount(regime, seed, monkeypatch):
    small = SMALL if regime == "load-4" else ms.SMALL_TABLE_ENTRIES
    monkeypatch.setattr(mesh, "SMALL_TABLE_ENTRIES", small)
    monkeypatch.setattr(ms, "SMALL_TABLE_ENTRIES", small)
    rng = np.random.default_rng(seed)
    n_spread, hot_n, per_bucket = 30_000, 30, 48
    n = n_spread + hot_n * per_bucket
    nb = _buckets_for(n, 4 if regime == "load-4" else 2)
    hot = rng.choice(nb, hot_n, replace=False)
    skewed = _homed_on(hot, nb, per_bucket, rng, np.zeros(0, np.uint64))
    spread = np.unique(rng.integers(1, 2**64 - 1, 2 * n_spread,
                                    dtype=np.uint64))
    spread = rng.permutation(spread[~np.isin(spread, skewed)])[:n_spread]
    hashes = rng.permutation(np.concatenate([skewed, spread]))
    ents = (hashes, rng.integers(0, 900, n).astype(np.int32),
            rng.integers(0, 5_000_000, n).astype(np.int32),
            rng.integers(0, 2, n).astype(bool))

    table = ms.DeviceIndex.build_table(*ents)
    t_bkt, mask, max_probes = table
    layout = table.layout
    assert layout == recount(t_bkt, small)
    assert layout.regime == regime and layout.entries == n
    assert layout.buckets == nb and mask == nb - 1
    assert layout.max_probes == max_probes >= LONG_CHAIN
    assert layout.table_bytes == t_bkt.nbytes
    assert layout.query_bytes == max_probes * 128
    jidx = mesh.DeviceIndex(*ents)
    assert np.array_equal(t_bkt, np.asarray(jidx.t_bkt))
    assert (mask, max_probes) == (jidx.mask, jidx.max_probes)
    assert ms.DeviceIndex.from_numpy(*table).layout is None


def _skewed_index(d):
    """The synthetic draft's index, and about 1,500 decoy entries on its
    last contig homed on the buckets of 40 of its minimizers: the reads'
    queries for those run down chains of five or more buckets. No read
    matches a decoy."""
    target = os.path.join(d, "target.fa")
    lengths = pipeline.read_scaffold_lengths(target)
    seqs = {}
    name = None
    with open(target) as fh:
        for line in fh:
            if line.startswith(">"):
                name = line[1:].strip()
            else:
                seqs[name] = np.frombuffer(line.strip().encode(), np.uint8)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    sketches = [(c, sketch_codes(lut[s], K, W)) for c, s in seqs.items()]
    real = np.unique(np.concatenate([m.hashes for _, m in sketches]))
    rng = np.random.default_rng(43)
    hot_n, per_bucket = 40, 40
    nb = _buckets_for(len(real) + hot_n * per_bucket, ms.BUCKET_LOAD)
    hot = np.unique(_home(rng.choice(real, hot_n, replace=False), nb))
    decoys = _homed_on(hot, nb, per_bucket, rng, real)
    index = ContigIndex()
    for c, mins in sketches:
        index.add_sketch(c, mins)
    last = sketches[-1][0]
    index.add_sketch(last, Minimizers(
        decoys, rng.integers(0, lengths[last] - K, len(decoys)),
        rng.integers(0, 2, len(decoys)).astype(bool)))
    index.finalize()
    return index, lengths


def _config(d, backend):
    return ScaffoldConfig(target=os.path.join(d, "target.fa"),
                          reads=[os.path.join(d, "reads.fa")], k=K, w=W,
                          z=Z, t=2, backend=backend, verbose=True,
                          batch_bases=400_000)


@pytest.fixture
def skewed(tmp_path, load4):
    write_dataset(tmp_path, seed=44, n_reads=120)
    index, lengths = _skewed_index(tmp_path)
    return tmp_path, index, lengths


class StepCalls:
    """Each eager `mapping_step` call's rows, slot budget and payload."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = device_map.mapping_step

        def step(packed, lengths, index, k, w, L, slots, **kw):
            out = real(packed, lengths, index, k, w, L, slots, **kw)
            self.calls.append((L, packed.shape[0], slots, out.numpy()))
            return out
        monkeypatch.setattr(device_map, "mapping_step", step)

    def slots(self) -> int:
        return sum(B * S for _, B, S, _ in self.calls)

    def queries(self) -> int:
        return sum(int(np.minimum(out[B: 2 * B], S).sum())
                   for _, B, S, out in self.calls)

    def batches_by_pad(self):
        out = {}
        for L, *_ in self.calls:
            out[L] = out.get(L, 0) + 1
        return out


def _map(d, cfg, index, lengths, mapper, tag):
    path = os.path.join(d, f"verbose.{tag}.tsv")
    pipeline.map_reads(cfg, index, lengths, path, None, mapper)
    with open(path, "rb") as fh:
        return fh.read()


def test_stream_counts_equal_a_recount_from_the_payloads(skewed,
                                                         monkeypatch):
    d, index, lengths = skewed
    for name, value in (("enabled", True), ("spans", []), ("counts", [])):
        monkeypatch.setattr(tracing.GLOBAL, name, value)
    calls = StepCalls(monkeypatch)
    cfg = _config(d, "jax")
    _, devices = pipeline.split_devices(cfg, "cpu")
    mapper = pipeline.make_mapper(cfg, index, lengths, devices)
    assert isinstance(mapper, device_map.TorchMapper) and mapper.prechained
    layout = mapper.didx.layout
    assert layout.regime == "load-4" and layout.entries == len(index)
    assert layout.max_probes >= LONG_CHAIN
    assert layout == recount(mapper.didx.t_bkt.numpy().view(np.uint32),
                             SMALL)

    got = _map(d, cfg, index, lengths, mapper, "torch")
    host = pipeline.make_mapper(_config(d, "numpy"), index, lengths, None)
    want = _map(d, _config(d, "numpy"), index, lengths, host, "host")
    assert got == want and got.count(b"\n") > 50

    join = mapper.join_stats
    assert calls.calls and mapper.host_fallbacks < 5
    assert join["slots"] == calls.slots()
    assert join["slots"] == sum(
        B * mapper._slots_for(L) for L, B, _, _ in calls.calls)
    by_pad = {}
    for (L, _), n in mapper.batches_by_pad.items():
        by_pad[L] = by_pad.get(L, 0) + n
    assert by_pad == calls.batches_by_pad()
    assert join["bucket_bytes"] == join["slots"] * layout.max_probes * 128
    assert join["queries"] == calls.queries()
    assert 0 < join["queries"] < join["slots"]


def test_tracer_takes_one_join_count_a_stream(skewed, monkeypatch):
    d, index, lengths = skewed
    cfg = _config(d, "jax")
    _, devices = pipeline.split_devices(cfg, "cpu")
    for enabled in (True, False):
        monkeypatch.setattr(tracing.GLOBAL, "enabled", enabled)
        monkeypatch.setattr(tracing.GLOBAL, "spans", [])
        monkeypatch.setattr(tracing.GLOBAL, "counts", [])
        calls = StepCalls(monkeypatch)
        mapper = pipeline.make_mapper(cfg, index, lengths, devices)
        per_stream = []
        for tag in ("a", "b"):
            before = dict(mapper.join_stats)
            _map(d, cfg, index, lengths, mapper, tag)
            per_stream.append({key: mapper.join_stats[key] - before[key]
                               for key in before})
        if not enabled:
            # the Tracer off: nothing counted, nothing recorded
            assert tracing.GLOBAL.counts == [] and calls.calls
            assert set(mapper.join_stats.values()) == {0}
            continue
        assert tracing.GLOBAL.counts_named("table/build") == [
            vars(mapper.didx.layout)]
        records = tracing.GLOBAL.counts_named("map/join")
        assert records == [dict(s, max_probes=mapper.didx.max_probes)
                           for s in per_stream]
        assert per_stream[0] == per_stream[1]
        assert sum(r["slots"] for r in records) == calls.slots()
        assert sum(r["queries"] for r in records) == calls.queries()
        # the consumer's count of each verbose stream comes before the
        # stream's own, which its summary line takes at the stream's end
        assert [c.name for c in tracing.GLOBAL.counts] == [
            "table/build", "render/verbose", "map/join", "map/decode",
            "render/verbose", "map/join", "map/decode"]
