"""The batches of both clients of the batched device stream
(``stream_pipeline.BatchStream``): the read mapper (`TorchMapper`) and the
contig sketcher (`TorchSketcher`), on fixed inputs with several pads,
rows with N, budget flushes mid-stream and a partial last flush. Each
client's `batches_by_pad` and the (pad, has N) key and height of every
batch that reaches its step are pinned to constants: the heights are the
step graphs' keys, so a change of them is a change of what the card
captures, not only of speed."""
import numpy as np
import pytest

from ntlink_tpu_torch import device_map, sketch
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.index import ContigIndex
from ntlink_tpu_torch.ops import nthash_np
from ntlink_tpu_torch.sketch import TorchSketcher

K, W = 32, 100
BATCH_BASES = 16_384   # a budget flush every 4 x 16,384 padded bases

#: the (pad, has N) and height of each batch at the mapper's step
MAPPER_STEPS = [
    ((16384, False), 1), ((8192, False), 2), ((16384, False), 1),
    ((1024, False), 8), ((2048, False), 2), ((4096, True), 1),
    ((2048, True), 1), ((4096, False), 1), ((16384, True), 1),
    ((8192, False), 2), ((16384, False), 1), ((2048, True), 1),
    ((1024, False), 8), ((2048, False), 4), ((4096, False), 2),
    ((1024, True), 1), ((16384, False), 1), ((8192, False), 2),
    ((16384, False), 1), ((2048, False), 4), ((1024, False), 4),
    ((1024, True), 2), ((4096, False), 2), ((16384, False), 1),
    ((16384, False), 1), ((2048, False), 4), ((1024, False), 8),
    ((4096, False), 1), ((8192, True), 1), ((4096, True), 1),
    ((8192, False), 1), ((16384, False), 1), ((8192, False), 2),
    ((16384, True), 1), ((2048, False), 2), ((1024, False), 8),
    ((2048, True), 2), ((4096, False), 2), ((2048, False), 1),
]
MAPPER_BATCHES = {
    (16384, False): 8, (8192, False): 5, (1024, False): 5, (2048, False): 6,
    (4096, True): 2, (2048, True): 3, (4096, False): 5, (16384, True): 2,
    (1024, True): 2, (8192, True): 1,
}
#: the same of the contig sketcher, MAX_PAD shrunk to 4096 (chunking)
SKETCHER_STEPS = [
    ((4096, False), 4), ((4096, False), 4), ((1024, False), 8),
    ((4096, False), 4), ((2048, False), 8), ((1024, True), 2),
    ((4096, False), 4), ((4096, False), 4), ((2048, False), 8),
    ((1024, False), 16), ((4096, True), 1), ((2048, True), 1),
    ((1024, True), 1), ((4096, False), 4), ((1024, False), 4),
    ((4096, False), 2), ((2048, False), 2), ((1024, True), 1),
]
SKETCHER_BATCHES = {
    (4096, False): 7, (1024, False): 3, (2048, False): 3, (1024, True): 3,
    (4096, True): 1, (2048, True): 1,
}


def _rows(seed: int, n: int, spans):
    """`n` random rows, their lengths drawn in turn from `spans`; every
    seventh row gets an N run."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(n):
        lo, hi = spans[r % len(spans)]
        c = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        if r % 7 == 3:
            c[len(c) // 3 : len(c) // 3 + 5] = 4
        rows.append((f"s{r}", c))
    return rows


def _recorded(monkeypatch, module, name):
    """[((pad, has N), height)] of every call of `module.name` from now
    on."""
    calls, real = [], getattr(module, name)

    def step(packed, lengths, *args, **kw):
        calls.append(((args[-2], kw.get("nmask") is not None),
                      packed.shape[0]))
        return real(packed, lengths, *args, **kw)

    monkeypatch.setattr(module, name, step)
    return calls


def _mapper_run(monkeypatch):
    rng = np.random.default_rng(3)
    contigs = [rng.integers(0, 4, 60_000).astype(np.uint8) for _ in range(3)]
    index = ContigIndex.from_sketches(
        (f"c{i}", nthash_np.sketch_codes(c, K, W))
        for i, c in enumerate(contigs))
    reads = _rows(11, 90, [(600, 1000), (1500, 2000), (600, 1000),
                           (3000, 4000), (600, 900), (5000, 8000),
                           (9000, 12000), (10, 30), (1200, 2000)])
    tm = TorchMapper(index, K, W, batch_bases=BATCH_BASES, device="cpu")
    calls = _recorded(monkeypatch, device_map, "mapping_step")
    got = list(tm.map_stream_raw(iter(reads)))
    assert [name for name, _, _ in got] == [name for name, _ in reads]
    return tm, calls


def _sketcher_run(monkeypatch):
    seqs = _rows(12, 70, [(600, 1000), (3000, 4000), (1500, 2000),
                          (5000, 9000), (600, 1000), (10, 25)])
    ts = TorchSketcher("cpu", batch_bases=BATCH_BASES)
    ts.MAX_PAD = 4096
    calls = _recorded(monkeypatch, sketch, "sketch_step")
    got = list(ts.sketch_stream(iter(seqs), K, W))
    assert [name for name, _, _ in got] == [name for name, _ in seqs]
    assert ts.chunked > 0
    return ts, calls


@pytest.mark.parametrize("client", ["mapper", "sketcher"])
def test_batches_keep_their_keys_and_heights(client, monkeypatch):
    run, steps, batches = {
        "mapper": (_mapper_run, MAPPER_STEPS, MAPPER_BATCHES),
        "sketcher": (_sketcher_run, SKETCHER_STEPS, SKETCHER_BATCHES),
    }[client]
    owner, calls = run(monkeypatch)
    assert calls == steps
    assert owner.batches_by_pad == batches
