"""Make-style incrementality of the port's flows, after
``tests/test_incremental.py``, on `synthetic.write_dataset` data in place
of the reference's scaffolds_1.fa: a second `scaffold_stage` (backend=auto
on the CPU device) rebuilds nothing (every artifact's mtime stays, and
neither the sketcher nor the mapper is reached), touching the reads
rebuilds the DOT with the same bytes, and the first run's directory is
ntlink_tpu's backend=numpy run's, file for file. A TorchSketcher whose step
raises leaves neither the TSV nor its .tmp, and a 0-byte TSV is sketched
again, to ntlink_tpu's bytes."""
import os

import pytest

from ntlink_tpu import pipeline as ref
from ntlink_tpu.config import ScaffoldConfig as RefConfig
from ntlink_tpu_torch import pipeline, sketch
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.sketch import (
    TorchHybridSketcher, TorchSketcher, sketch_fasta_to_tsv,
)

from .synthetic import assert_same_tree, write_dataset

KW = dict(target="target.fa", reads=["reads.fa"], k=32, w=250, z=1000)


class Boom(RuntimeError):
    pass


def test_second_run_reuses_artifacts(tmp_path, monkeypatch):
    for side in ("torch", "numpy"):
        write_dataset(tmp_path / side, seed=91)
    monkeypatch.chdir(tmp_path / "numpy")
    ref.scaffold_stage(RefConfig(backend="numpy", **KW))
    monkeypatch.chdir(tmp_path / "torch")
    cfg = ScaffoldConfig(**KW)
    pipeline.scaffold_stage(cfg, device="cpu")
    prefix = cfg.resolved_prefix()
    artifacts = [
        f"{prefix}.n1.scaffold.dot",
        f"{prefix}.stitch.path",
        f"{prefix}.trimmed_scafs.fa",
        "target.fa.k32.w250.z1000.stitch.abyss-scaffold.fa",
    ]
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy", artifacts)
    mtimes = {a: os.path.getmtime(a) for a in artifacts}
    dot = open(artifacts[0], "rb").read()

    def boom(*a, **kw):
        raise Boom("a fresh artifact was rebuilt")

    with monkeypatch.context() as m:
        m.setattr(pipeline, "map_reads", boom)
        m.setattr(TorchSketcher, "sketch_stream", boom)
        pipeline.scaffold_stage(cfg, device="cpu")  # everything fresh
    for a in artifacts:
        assert os.path.getmtime(a) == mtimes[a], f"{a} was rebuilt"

    # touching the reads invalidates mapping and everything downstream
    os.utime("reads.fa")
    pipeline.scaffold_stage(cfg, device="cpu")
    assert os.path.getmtime(artifacts[0]) > mtimes[artifacts[0]]
    assert open(artifacts[0], "rb").read() == dot
    assert pipeline.last_mapper.device_reads > 0


def test_killed_sketch_leaves_no_reusable_artifact(tmp_path, monkeypatch):
    """A contig sketch killed mid-stream must not leave a TSV that the next
    run's freshness check would reuse (tmp + rename write), and a 0-byte
    TSV is stale rather than an empty index."""
    fa = tmp_path / "t.fa"
    fa.write_text(">c1\n" + "ACGT" * 300 + "\n" + ">c2\n" + "ACGGT" * 400
                  + "\n")
    out = tmp_path / "t.tsv"

    def bad_step(*a, **kw):
        raise Boom("sketch step failed")

    with monkeypatch.context() as m:
        m.setattr(sketch, "sketch_step", bad_step)
        with pytest.raises(Boom):
            sketch_fasta_to_tsv(str(fa), str(out), 16, 10,
                                backend=TorchSketcher("cpu"))
    assert not out.exists()
    assert not any(p.name.startswith("t.tsv.tmp") for p in tmp_path.iterdir())

    # legacy truncated artifact: fresh mtime but zero bytes -> re-sketched
    cfg = ScaffoldConfig(target=str(fa), reads=[], k=16, w=10)
    stale = tmp_path / "t.fa.k16.w10.tsv"
    stale.write_bytes(b"")
    got = pipeline.ensure_contig_sketch_tsv(cfg, 16, 10, device="cpu")
    # the default knobs (t=4): the device and the host's C threads share
    # the stream, and between them deliver both contigs
    sk = pipeline.last_sketcher
    assert isinstance(sk, TorchHybridSketcher)
    assert sk.device_seqs + sk.host_seqs == 2
    body = open(got, "rb").read()
    assert len(body) > 0
    stale.write_bytes(b"")
    ref_cfg = RefConfig(target=str(fa), reads=[], k=16, w=10,
                        backend="numpy")
    assert ref.ensure_contig_sketch_tsv(ref_cfg, 16, 10) == got
    assert open(got, "rb").read() == body
