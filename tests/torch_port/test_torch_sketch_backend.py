"""`sketch.get_backend` (the `pair` stage's contig-sketch dispatch) against
``ntlink_tpu.sketch.get_backend``, and the contig sketch it gives at the
default knobs against ``ntlink_tpu``'s, byte for byte.

backend=auto with t > 1 and the C sketcher built shares the contig stream
between the device and the host's C threads (TorchHybridSketcher, as
HybridSketcher); the artifacts do not depend on the split. The last tests
hold the hybrid sketch path where it could differ from the device path
alone: contigs past MAX_PAD on either path, chunk seams in every block,
and the counters a killed stream leaves.
"""
import filecmp
import os

import numpy as np
import pytest

import ntlink_tpu.native as jax_native
from ntlink_tpu import pipeline as ref
from ntlink_tpu import sketch as jax_sketch
from ntlink_tpu.config import ScaffoldConfig as RefConfig
from ntlink_tpu_torch import pipeline, sketch
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.native import sketch_module
from ntlink_tpu_torch.sketch import TorchHybridSketcher, TorchSketcher

from .synthetic import write_dataset

#: the JAX package's sketcher class name -> the port's
COUNTERPART = {"HybridSketcher": "TorchHybridSketcher",
               "JaxSketcher": "TorchSketcher", "NoneType": "NoneType"}
CONTIG_TSV = "target.fa.k32.w100.tsv"
N_CONTIGS = 4  # synthetic.write_dataset's draft


def _choice(fn):
    """(class name, threads, host_frac) of `fn()`'s sketcher, or the type
    of what it raised."""
    try:
        got = fn()
    except Exception as exc:  # noqa: BLE001 - the type is the result
        return type(exc)
    return (type(got).__name__, getattr(got, "threads", None),
            getattr(got, "host_frac", None))


@pytest.mark.parametrize("built", [True, False], ids=["C-built", "no-C"])
@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("name", ["auto", "jax", "hybrid", "numpy"])
def test_get_backend_matches_the_jax_package(name, threads, built,
                                             monkeypatch):
    if not built:
        monkeypatch.setattr(jax_native, "sketch_module", lambda: None)
        monkeypatch.setattr(sketch, "sketch_module", lambda: None)
    elif sketch_module() is None:
        pytest.fail("the port's C sketcher did not build")
    want = _choice(lambda: jax_sketch.get_backend(name, threads=threads))
    got = _choice(lambda: sketch.get_backend(name, threads=threads,
                                             device="cpu"))
    if isinstance(want, type):
        assert got is want
        return
    assert got == (COUNTERPART[want[0]], *want[1:])
    # the dispatch of the JAX package's pair stage, case by case
    hybrid = name == "hybrid" or (name == "auto" and threads > 1)
    if name == "numpy":
        assert got[0] == "NoneType"
    elif hybrid and built:
        assert got == ("TorchHybridSketcher", threads, -1.0)
    else:
        assert got[0] == "TorchSketcher"


def test_hybrid_without_the_c_sketcher_raises(monkeypatch, tmp_path):
    """backend=hybrid never carries on through the NumPy hasher: the pair
    stage's contig sketch raises, and writes nothing."""
    write_dataset(tmp_path, n_reads=4)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sketch, "sketch_module", lambda: None)
    cfg = ScaffoldConfig(target="target.fa", reads=["reads.fa"],
                         backend="hybrid")
    with pytest.raises(RuntimeError, match="native C sketch module"):
        pipeline.ensure_contig_sketch_tsv(cfg, 32, 100, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["reads.fa", "target.fa"]


@pytest.mark.parametrize("host_frac", [-1.0, 0.5])
def test_hybrid_sketcher_needs_the_c_sketcher(monkeypatch, host_frac):
    """TorchHybridSketcher built directly, not through get_backend, raises
    too: its host path is the C thread pool, never the NumPy hasher."""
    monkeypatch.setattr(sketch, "sketch_module", lambda: None)
    with pytest.raises(RuntimeError, match="native C sketch module"):
        TorchHybridSketcher("cpu", threads=2, host_frac=host_frac)


@pytest.mark.parametrize("blocks", ["default quanta", "a contig a block"])
@pytest.mark.parametrize("ref_backend", ["auto", "numpy"])
def test_default_contig_sketch_is_hybrid_and_byte_identical(
        tmp_path, monkeypatch, ref_backend, blocks):
    """At the default knobs (backend=auto, t=4) the port's contig sketch
    goes through TorchHybridSketcher, every contig is delivered by one of
    its paths, the card's first, and the TSV is ntlink_tpu's at
    backend=auto (its HybridSketcher on JAX's CPU) and at backend=numpy."""
    if blocks != "default quanta":
        monkeypatch.setattr(sketch, "HYBRID_BLOCK_ITEMS", 1)
    for side in ("torch", "ref"):
        write_dataset(tmp_path / side, seed=21, n_reads=4)
    monkeypatch.chdir(tmp_path / "torch")
    cfg = ScaffoldConfig(target="target.fa", reads=["reads.fa"])
    assert (cfg.backend, cfg.t) == ("auto", 4)
    assert pipeline.ensure_contig_sketch_tsv(cfg, 32, 100,
                                             device="cpu") == CONTIG_TSV
    sk = pipeline.last_sketcher
    assert isinstance(sk, TorchHybridSketcher)
    assert (sk.threads, sk.host_frac) == (4, -1.0)
    assert sk.host_seqs + sk.device_seqs == N_CONTIGS
    # the scheduler hands its first block to the device
    assert sk.device_seqs >= 1 and sk.device_rows >= 1
    assert sk.device_bases + sk.host_bases >= 4 * 60_000
    monkeypatch.chdir(tmp_path / "ref")
    rcfg = RefConfig(target="target.fa", reads=["reads.fa"],
                     backend=ref_backend)
    assert ref.ensure_contig_sketch_tsv(rcfg, 32, 100) == CONTIG_TSV
    assert filecmp.cmp(tmp_path / "torch" / CONTIG_TSV,
                       tmp_path / "ref" / CONTIG_TSV, shallow=False)


@pytest.mark.parametrize("t,want", [(1, "TorchSketcher"),
                                    (4, "TorchHybridSketcher")])
def test_auto_follows_the_host_threads(tmp_path, monkeypatch, t, want):
    """backend=auto sketches the contigs on the device alone at t=1 and
    shares the stream at t > 1; the same bytes either way."""
    write_dataset(tmp_path, seed=22, n_reads=4)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(target="target.fa", reads=["reads.fa"], t=t)
    pipeline.ensure_contig_sketch_tsv(cfg, 32, 100, device="cpu")
    assert type(pipeline.last_sketcher).__name__ == want
    got = open(CONTIG_TSV, "rb").read()
    os.remove(CONTIG_TSV)
    ref.ensure_contig_sketch_tsv(
        RefConfig(target="target.fa", reads=["reads.fa"], backend="numpy"),
        32, 100)
    assert open(CONTIG_TSV, "rb").read() == got


@pytest.mark.parametrize("backend", ["hybrid", "auto"])
def test_hybrid_host_frac_pins_the_reads_only(tmp_path, monkeypatch,
                                              backend):
    """hybrid_host_frac pins the read mapping's share; the contig sketch
    stays adaptive (get_backend never passes it), as in ntlink_tpu."""
    write_dataset(tmp_path, seed=23, n_reads=4)
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(target="target.fa", reads=["reads.fa"],
                         backend=backend, hybrid_host_frac=0.25)
    pipeline.ensure_contig_sketch_tsv(cfg, 32, 100, device="cpu")
    sk = pipeline.last_sketcher
    assert isinstance(sk, TorchHybridSketcher)
    assert sk.host_frac == -1.0
    got = open(CONTIG_TSV, "rb").read()
    os.remove(CONTIG_TSV)
    jax_sk = jax_sketch.get_backend(backend, threads=cfg.t)
    assert jax_sk.host_frac == sk.host_frac
    ref.ensure_contig_sketch_tsv(
        RefConfig(target="target.fa", reads=["reads.fa"], backend="numpy"),
        32, 100)
    assert open(CONTIG_TSV, "rb").read() == got


def _native(codes, k, w):
    _, hb, pb, fb = sketch_module().sketch(codes, k, w)
    return (np.frombuffer(hb, np.uint64), np.frombuffer(pb, np.int64),
            np.frombuffer(fb, np.uint8).astype(bool))


@pytest.mark.parametrize("host_frac", [-1.0, 0.5, 1.0])
def test_chunk_seams_in_every_block(host_frac, monkeypatch):
    """Contigs of ~18 chunks each (MAX_PAD shrunk to 512), one contig a
    block, so both paths take chunked contigs (the C path whole, the device
    path chunked, its seam dedup at every chunk's first window) and the
    blocks alternate between them; and low-complexity runs across seams,
    where the chunk's first winner repeats the last one. The adaptive case
    pins only that the device takes the first block."""
    monkeypatch.setattr(sketch, "HYBRID_BLOCK_ITEMS", 1)
    k, w, n = 15, 5, 9000
    rng = np.random.default_rng(24)
    seqs = []
    for i in range(8):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        if i % 2:
            seam = 512 - (k + w - 2)
            for c in range(1, n // seam):
                codes[c * seam - 30 : c * seam + 30] = 0
        seqs.append((f"c{i}", codes))
    hs = TorchHybridSketcher("cpu", threads=2, host_frac=host_frac)
    hs.device_backend.MAX_PAD = 512
    hs.device_backend.batch_bases = 8 * 512
    got = list(hs.sketch_stream(iter(seqs), k, w))
    assert [g[:2] for g in got] == [(name, n) for name, _ in seqs]
    for (name, codes), (_, _, m) in zip(seqs, got):
        h, p, f = _native(codes, k, w)
        assert np.array_equal(m.hashes, h), name
        assert np.array_equal(m.positions, p), name
        assert np.array_equal(m.forward, f), name
    assert hs.host_seqs + hs.device_seqs == len(seqs)
    assert hs.device_backend.chunked >= hs.device_seqs
    if host_frac < 1.0:
        assert hs.device_seqs >= 1
    if host_frac == 0.5:
        assert hs.host_seqs == hs.device_seqs == 4


def test_four_mb_contigs_on_both_paths(monkeypatch):
    """Two contigs of the human preset's 4 Mb (two chunks each at the real
    MAX_PAD), one on each path (host_frac 0.5, a contig a block): the C
    path sketches each whole, the device path in window-aligned chunks."""
    monkeypatch.setattr(sketch, "HYBRID_BLOCK_ITEMS", 1)
    k, w = 32, 100
    rng = np.random.default_rng(25)
    seqs = [(f"big{i}", rng.integers(0, 4, 4_000_000).astype(np.uint8))
            for i in range(2)]
    hs = TorchHybridSketcher("cpu", threads=2, host_frac=0.5)
    got = list(hs.sketch_stream(iter(seqs), k, w))
    for (name, codes), (gname, glen, m) in zip(seqs, got):
        h, p, f = _native(codes, k, w)
        assert (gname, glen) == (name, len(codes))
        assert np.array_equal(m.hashes, h), name
        assert np.array_equal(m.positions, p), name
        assert np.array_equal(m.forward, f), name
    assert (hs.device_seqs, hs.host_seqs) == (1, 1)
    assert hs.chunked == 1 and hs.device_rows == 2
    assert hs.device_bases == hs.host_bases == 4_000_000


class Killed(RuntimeError):
    pass


@pytest.mark.parametrize("backend,kill_at", [("jax", 2), ("auto", 1)],
                         ids=["card-alone", "default-hybrid"])
def test_counters_after_a_killed_sketch(tmp_path, monkeypatch, backend,
                                        kill_at):
    """A contig sketch whose device step raises: on the device alone at its
    second step, and at the default knobs (the hybrid) at the device's
    first, which the scheduler always hands it. The error reaches the
    caller, no TSV and no .tmp is left, and the sketcher's batches are the
    steps that were issued, one kernel launch each, not the one that
    raised."""
    rng = np.random.default_rng(26)
    with open(tmp_path / "t.fa", "w") as fh:
        for i in range(6):
            seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 3000)])
            fh.write(f">c{i}\n{seq}\n")
    real_step, calls, issued = sketch.sketch_step, [0], [0]

    def dying_step(*args, **kwargs):
        calls[0] += 1
        if calls[0] == kill_at:
            raise Killed(f"step {kill_at}")
        out = real_step(*args, **kwargs)
        issued[0] += 1
        return out

    monkeypatch.setattr(sketch, "sketch_step", dying_step)
    # one contig a batch
    real_init = TorchSketcher.__init__
    monkeypatch.setattr(
        TorchSketcher, "__init__",
        lambda self, device=None, batch_bases=0: real_init(self, device,
                                                           4096))
    monkeypatch.chdir(tmp_path)
    cfg = ScaffoldConfig(target="t.fa", reads=[], k=20, w=10,
                         backend=backend)
    with pytest.raises(Killed):
        pipeline.ensure_contig_sketch_tsv(cfg, 20, 10, device="cpu")
    assert os.listdir(tmp_path) == ["t.fa"]
    sk = pipeline.last_sketcher
    assert type(sk).__name__ == ("TorchSketcher" if backend == "jax"
                                 else "TorchHybridSketcher")
    assert sum(sk.batches_by_pad.values()) == issued[0] == kill_at - 1
    assert sk.device_rows <= issued[0]
