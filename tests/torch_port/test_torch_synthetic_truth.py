"""The whole engine of the port against synthetic ground truth, after
``tests/test_synthetic_truth.py`` and with its generators: a random genome
is split into contigs with known 500 b gaps, and reads sampled across it
drive `pipeline.run_scaffold` (backend=auto on the CPU device: the read
mapping and the device's share of the contig sketch go through the
kernel's plain version, the rest of the contigs through the host's C
threads) to one
path in the true order and orientation with every gap estimate within
200-800 b; the gap-fill variant patches both gaps with read sequence.
Every file each run leaves is byte for byte ntlink_tpu's backend=numpy
run on the same input."""
import os

import numpy as np

from ntlink_tpu import pipeline as ref
from ntlink_tpu.config import ScaffoldConfig as RefConfig
from ntlink_tpu_torch import pipeline
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.sketch import TorchHybridSketcher

from test_synthetic_truth import make_genome, sample_reads

from .synthetic import assert_same_tree


def _write(dirs, contigs, reads):
    for d in dirs:
        os.makedirs(d)
        with open(os.path.join(d, "target.fa"), "w") as fh:
            for name, seq in contigs:
                fh.write(f">{name}\n{seq}\n")
        with open(os.path.join(d, "reads.fa"), "w") as fh:
            for name, seq in reads:
                fh.write(f">{name}\n{seq}\n")


def _both(tmp_path, monkeypatch, gap_fill):
    """run_scaffold through the port (backend=auto, CPU device) and through
    ntlink_tpu (backend=numpy) in two directories; the port's final path
    after the directories were compared."""
    kw = dict(target="target.fa", reads=["reads.fa"], k=32, w=100, z=1000)
    monkeypatch.chdir(tmp_path / "torch")
    cfg = ScaffoldConfig(**kw)
    final = pipeline.run_scaffold(cfg, gap_fill=gap_fill, device="cpu")
    # the default knobs (t=4): the contig sketch shared between the device
    # and the host's C threads, every contig delivered by one of them
    sk = pipeline.last_sketcher
    assert isinstance(sk, TorchHybridSketcher)
    assert sk.device_seqs >= 1
    assert sk.device_seqs + sk.host_seqs == len(
        pipeline.read_scaffold_lengths("target.fa"))
    assert pipeline.last_mapper.device_reads > 0
    monkeypatch.chdir(tmp_path / "numpy")
    assert ref.run_scaffold(RefConfig(backend="numpy", **kw),
                            gap_fill=gap_fill) == final
    stem = "target.fa.k32.w100.z1000"
    must = [final, f"{stem}.n1.scaffold.dot", f"{stem}.stitch.path",
            f"{stem}.verbose_mapping.tsv"]
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy", must)
    monkeypatch.chdir(tmp_path / "torch")
    return cfg, final


def test_reassembles_synthetic_genome(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    genome, contigs = make_genome(rng)
    _write([tmp_path / "torch", tmp_path / "numpy"], contigs,
           sample_reads(rng, genome))
    cfg, final = _both(tmp_path, monkeypatch, gap_fill=False)

    with open(f"{cfg.resolved_prefix()}.stitch.path") as fh:
        paths = [line.rstrip("\n").split("\t")[1] for line in fh]
    assert len(paths) == 1, paths
    tokens = paths[0].split(" ")
    names = [t[:-1] for t in tokens[::2]]
    oris = [t[-1] for t in tokens[::2]]
    gaps = [int(t[:-1]) for t in tokens[1::2]]
    expected = [f"contig{i}" for i in range(len(contigs))]
    if names != expected:
        names, oris = names[::-1], ["-" if o == "+" else "+" for o in oris[::-1]]
    assert names == expected
    assert len(set(oris)) == 1  # consistent orientation through the chain
    for g in gaps:
        assert 200 <= g <= 800, f"gap estimate {g} far from truth 500"
    # final fasta: one scaffold spanning all contigs
    headers = [l for l in open(os.path.realpath(final)) if l.startswith(">")]
    assert len(headers) == 1


def test_gap_fill_recovers_gap_sequence(tmp_path, monkeypatch):
    rng = np.random.default_rng(12)
    genome, contigs = make_genome(rng, n_contigs=3, contig_len=300_000)
    _write([tmp_path / "torch", tmp_path / "numpy"], contigs,
           sample_reads(rng, genome, n_reads=500))
    _, out = _both(tmp_path, monkeypatch, gap_fill=True)
    seqs, seq = [], None
    for line in open(out):
        if line.startswith(">"):
            if seq is not None:
                seqs.append(seq)
            seq = ""
        else:
            seq += line.strip()
    seqs.append(seq)
    big = max(seqs, key=len)
    # both gaps patched with read-derived sequence: scaffold length close to
    # the genome, and only a tiny N fraction left
    assert abs(len(big) - len(genome)) < 0.02 * len(genome)
    assert big.upper().count("N") < 0.01 * len(big)


def test_smoke_generator_is_this_tests():
    """`chip_smoke.py` phase 14c builds its genome of known truth with a
    copy of the generators above (the smoke imports nothing of the JAX
    package's tests): the same seed gives the same genome and reads."""
    import importlib.util
    import inspect

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for mine, theirs in ((smoke.truth_genome, make_genome),
                         (smoke.truth_reads, sample_reads)):
        assert inspect.signature(mine) == inspect.signature(theirs)
    for seed in (11, 12):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        genome, contigs = smoke.truth_genome(a, 3, 5000, 300)
        assert (genome, contigs) == make_genome(b, 3, 5000, 300)
        assert smoke.truth_reads(a, genome, 30, 800, 0.05) == \
            sample_reads(b, genome, 30, 800, 0.05)
