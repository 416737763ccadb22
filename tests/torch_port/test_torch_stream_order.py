"""Incremental in-order delivery of the port's device mapping stream, after
``tests/test_stream_order.py``: `map_stream_raw` yields each read's result
as soon as its batch has drained, in exactly the input order, and the
payloads are those of ``ntlink_tpu``'s exact host path
(``DeviceMapper._host_map_raw``), across several pad buckets, several
flushed batches per bucket, and sub-k reads between device reads; on one
CPU device, on two, and on the hash grid. Each case also runs with
NTLINK_TIMING=1. Every comparison is exact. Through `pipeline.map_reads`
the reads file comes in blocks, one reader hand-off a block."""
import dataclasses
import re
import time

import numpy as np
import pytest

from ntlink_tpu.device_map import DeviceMapper
from ntlink_tpu.index import ContigIndex
from ntlink_tpu.ops import nthash_np
from ntlink_tpu_torch import pipeline
from ntlink_tpu_torch.bench import tally_contents
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.device_map import PAIR_BLOCK_READS, TorchMapper
from ntlink_tpu_torch.index import ContigIndex as PortIndex
from ntlink_tpu_torch.seqio.fastx import stream_code_blocks

from .synthetic import write_dataset

K, W = 32, 100


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(11)
    contig = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 120_000)])
    index = ContigIndex.from_sketches(
        [("ctg0", nthash_np.sketch_sequence(contig, K, W))]
    )
    reads = []
    for i in range(70):
        # alternate pad buckets (1024 and 2048), N reads and sub-k reads
        if i % 11 == 10:
            start = int(rng.integers(0, 100_000))
            seq = contig[start : start + 900]
            if i % 22 == 10:
                seq = seq[:400] + "N" + seq[401:]
            else:
                seq = seq[:300] + "N" * 60 + seq[360:]
        elif i % 7 == 6:
            seq = "ACG"  # shorter than k: the exact host path
        else:
            ln = 900 if i % 2 == 0 else 1800
            start = int(rng.integers(0, 100_000 - ln))
            seq = contig[start : start + ln]
        reads.append((f"r{i}", seq))
    return index, reads


def _expected(index, reads):
    """Ground truth: the JAX package's mapper's own exact host path."""
    mapper = DeviceMapper(index, K, W, batch_bases=16_384, use_mesh=False)
    return [(name, len(seq), mapper._host_map_raw(nthash_np.encode(seq)))
            for name, seq in reads]


@pytest.mark.parametrize("layout", ["one device", "two devices", "hash grid"])
def test_incremental_delivery_order_and_parity(workload, layout, timing_env):
    index, reads = workload
    kw = {
        "one device": dict(device="cpu"),
        "two devices": dict(devices=["cpu"] * 2),
        "hash grid": dict(devices=["cpu"] * 2, index_sharding="hash",
                          idx_shards=2),
    }[layout]
    # tiny batch_bases: the 1024-pad bucket flushes every 16 reads, the
    # 2048-pad bucket every 8, so many batches are in flight
    mapper = TorchMapper(index, K, W, batch_bases=16_384, **kw)
    expected = _expected(index, reads)
    got = list(mapper.map_stream_raw(iter(reads)))
    assert [(n, l) for n, l, _ in got] == [(n, l) for n, l, _ in expected]
    for (_, _, raw_g), (_, _, raw_e) in zip(got, expected):
        if raw_e is None:
            assert raw_g is None
            continue
        n_g, n_e = raw_g[0], raw_e[0]
        assert n_g == n_e
        for a, b in zip(raw_g[1:5], raw_e[1:5]):
            np.testing.assert_array_equal(np.asarray(a)[:n_g],
                                          np.asarray(b)[:n_e])
    assert mapper.host_fallbacks == sum(len(s) < K for _, s in reads)
    if timing_env:
        # one pull per block of the per-record reads
        assert mapper.last_timing["reader_pull"][1] == -(
            -len(reads) // PAIR_BLOCK_READS)
        assert mapper.last_timing["pack"][1] == \
            sum(mapper.batches_by_pad.values())


def test_results_surface_before_stream_end(workload, timing_env):
    """With several batches, at least one result is delivered before the
    input is exhausted (no all-at-the-end buffering). After enough reads to
    flush several batches the input pauses, so that the batches in flight
    drain and the next pull releases the front of the window."""
    index, reads = workload
    mapper = TorchMapper(index, K, W, batch_bases=16_384, device="cpu")
    pulled = [0]

    def feeding():
        for i, r in enumerate(reads):
            if i == 50:
                time.sleep(0.5)
            pulled[0] += 1
            yield r

    stream = mapper.map_stream_raw(feeding())
    first_at = None
    for _ in stream:
        first_at = pulled[0]
        break
    stream.close()
    assert first_at is not None and first_at < len(reads)


def test_reader_hands_reads_over_in_blocks(tmp_path, monkeypatch, capfd):
    """Through `pipeline.map_reads`, a TorchMapper takes the reads file in
    blocks: one `reader_pull` and one `reader_parse` a block, the blocks
    those of `stream_code_blocks`, at most one a 50 reads on a stream of
    1,000 reads and more, and the stream's summary line gives the blocks
    and the reads a block. The tally is the exact host path's."""
    monkeypatch.setenv("NTLINK_TIMING", "1")
    d = str(tmp_path)
    write_dataset(d, seed=29, n_reads=1_000, read_len=(1_500, 3_000))
    cfg = ScaffoldConfig(target=f"{d}/target.fa", reads=[f"{d}/reads.fa"],
                         k=K, w=W, z=1000, t=4, batch_bases=200_000)
    tsv = pipeline.ensure_contig_sketch_tsv(cfg, K, W, device="cpu")
    index = PortIndex.from_tsv(tsv)
    lengths = pipeline.read_scaffold_lengths(cfg.target)
    mapper = pipeline.make_mapper(cfg, index, lengths, ["cpu"])
    assert isinstance(mapper, TorchMapper)
    tally = pipeline.map_reads(cfg, index, lengths, None, None, mapper)
    n_reads = mapper.device_reads + mapper.host_fallbacks
    assert n_reads == 1_002
    blocks = sum(1 for _ in stream_code_blocks(cfg.reads[0],
                                               TorchMapper.BLOCK_BASES))
    timing = mapper.last_timing
    assert timing["reader_pull"][1] == timing["reader_parse"][1] == \
        mapper.read_blocks == blocks
    assert 1 <= blocks <= n_reads / 50
    assert timing["read_prep"][1] == n_reads
    summary = re.findall(r"device-map .*: (\d+) read\(s\) in .* in (\d+) "
                         r"block\(s\) of ([\d.]+) reads;",
                         capfd.readouterr().err)
    assert summary == [(str(n_reads), str(blocks),
                        f"{n_reads / blocks:.1f}")]
    # the runs-only consumer's tally, against the host mapper's
    host_cfg = dataclasses.replace(cfg, backend="numpy")
    host = pipeline.map_reads(
        host_cfg, index, lengths, None, None,
        pipeline.make_mapper(host_cfg, index, lengths, None))
    want = tally_contents(host)
    assert tally_contents(tally) == want and len(want) > 0
