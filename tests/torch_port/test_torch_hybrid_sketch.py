"""`sketch.TorchHybridSketcher` (backend=hybrid's contig sketch: a
TorchSketcher on the CPU device and the native C thread pool over one
stream), after ``tests/test_hybrid_sketch.py``: bit-exact with
``ntlink_tpu``'s `nthash_np` and in input order whatever the split
(`host_frac` 0.5, 0, 1 and adaptive), both paths taking sequences at 0.5;
rows past the device path's MAX_PAD chunk there and sketch whole on the
host, identical either way, both at a shrunk MAX_PAD (the JAX test's
4096) and past the real one (2^21 bases); and `pipeline.
ensure_contig_sketch_tsv` picks this sketcher, with the run's threads, for
backend=hybrid (the counterpart of `get_backend("hybrid")`). Exact
comparison everywhere."""
import numpy as np
import pytest

from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu.ops import nthash_np
from ntlink_tpu_torch import pipeline, sketch
from ntlink_tpu_torch.native import sketch_module
from ntlink_tpu_torch.sketch import TorchHybridSketcher, TorchSketcher


def random_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def make_mixed_seqs(rng, k, w):
    seqs = [
        (f"s{i}", random_seq(rng, int(n)))
        for i, n in enumerate(rng.integers(w + k + 5, 6000, size=24))
    ]
    seqs.append(("withn", random_seq(rng, 900) + "NNN" + random_seq(rng, 900)))
    seqs.append(("short", "ACGTACG"))
    return seqs


@pytest.fixture
def small_blocks(monkeypatch):
    """Assignment blocks of 4 sequences, as the JAX test's block_items=4,
    so that a short stream splits between the paths."""
    monkeypatch.setattr(sketch, "HYBRID_BLOCK_ITEMS", 4)


@pytest.mark.parametrize("host_frac", [0.5, 0.0, 1.0, -1.0])
def test_hybrid_sketch_parity(host_frac, small_blocks):
    k, w = 20, 10
    rng = np.random.default_rng(11)
    seqs = make_mixed_seqs(rng, k, w)
    hs = TorchHybridSketcher("cpu", threads=2, host_frac=host_frac)
    hs.device_backend.batch_bases = 20_000
    got = list(hs.sketch_stream(iter(seqs), k, w))
    assert [n for n, _, _ in got] == [n for n, _ in seqs]  # order
    for (name, seq), (_, glen, m) in zip(seqs, got):
        ref = nthash_np.sketch_sequence(seq, k, w)
        assert glen == len(seq)
        assert np.array_equal(m.hashes, ref.hashes), name
        assert np.array_equal(m.positions, ref.positions), name
        assert np.array_equal(m.forward, ref.forward), name
    assert hs.host_seqs + hs.device_seqs == len(seqs)
    if host_frac == 0.5:
        assert hs.host_seqs > 0 and hs.device_seqs > 0  # both paths ran


@pytest.mark.parametrize("k,w,n,max_pad", [
    (15, 5, 9000, 4096),
    (32, 100, TorchSketcher.MAX_PAD + 9000, TorchSketcher.MAX_PAD),
], ids=["shrunk-max-pad", "past-2^21"])
def test_hybrid_sketch_long_chunked_rows(k, w, n, max_pad, monkeypatch):
    """Oversized rows chunk on the device path and sketch whole on the host
    path; identical either way."""
    monkeypatch.setattr(sketch, "HYBRID_BLOCK_ITEMS", 1)
    rng = np.random.default_rng(7)
    hs = TorchHybridSketcher("cpu", threads=2, host_frac=0.5)
    hs.device_backend.batch_bases = 20_000
    hs.device_backend.MAX_PAD = max_pad
    count = 6 if n < max_pad * 4 else 2
    seqs = [(f"L{i}", rng.integers(0, 4, n).astype(np.uint8))
            for i in range(count)]
    got = list(hs.sketch_stream(iter(seqs), k, w))
    sm = sketch_module()
    for (name, codes), (gname, glen, m) in zip(seqs, got):
        _, hb, pb, fb = sm.sketch(codes, k, w)
        assert (gname, glen) == (name, n)
        assert np.array_equal(m.hashes, np.frombuffer(hb, np.uint64)), name
        assert np.array_equal(m.positions, np.frombuffer(pb, np.int64)), name
        assert np.array_equal(m.forward,
                              np.frombuffer(fb, np.uint8).astype(bool)), name
    assert hs.host_seqs > 0 and hs.device_seqs > 0
    assert hs.device_backend.chunked == hs.device_seqs
    if n < 20_000:  # the native and NumPy sketchers agree (the reference)
        ref = nthash_np.sketch_codes(seqs[0][1], k, w)
        assert np.array_equal(got[0][2].hashes, ref.hashes)


def test_hybrid_backend_picks_the_hybrid_sketcher(tmp_path, monkeypatch):
    """backend=hybrid's contig sketch goes through TorchHybridSketcher with
    the run's threads (``get_backend("hybrid", threads=3)``), and its TSV is
    ntlink_tpu's backend=numpy TSV."""
    from ntlink_tpu import pipeline as ref

    rng = np.random.default_rng(12)
    with open(tmp_path / "t.fa", "w") as fh:
        for i in range(6):
            fh.write(f">c{i}\n{random_seq(rng, 5000)}\n")
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(target="t.fa", reads=["r.fa"], k=20, w=10,
                         backend="hybrid", t=3)
    tsv = pipeline.ensure_contig_sketch_tsv(cfg, 20, 10, device="cpu")
    sk = pipeline.last_sketcher
    assert isinstance(sk, TorchHybridSketcher)
    assert sk.threads == 3
    assert sk.host_seqs + sk.device_seqs == 6
    got = open(tsv, "rb").read()
    (tmp_path / tsv).rename(tmp_path / "port.tsv")
    cfg.backend = "numpy"
    assert ref.ensure_contig_sketch_tsv(cfg, 20, 10) == tsv
    assert open(tsv, "rb").read() == got
