"""Robustness edge cases of the port, after ``tests/test_edge_cases.py``:
reads that map nowhere, contigs shorter than k, gap-fill with nothing to
fill and an empty reads file each run through the port's flows
(backend=auto on the CPU device) to the same directory as ntlink_tpu's
backend=numpy flow on the same input, byte for byte, and so do an all-N
contig and read, and reads of k, k+1 and k+w-2 bases. The reference-data
tests run on `synthetic.write_dataset` data: `./ntLink_torch scaffold
... -B` as a process, and `scaffold conservative=False k=24 w=250` through
the port's command line (`cli.parse` and `cli.dispatch`, the CPU device),
each against ntlink_tpu's command line. Then the port's parameter
refusals (`cli.build_config`), its native chainer with hundreds of
distinct contigs in one read, and `device_map.default_idx_shards`."""
import os
import random
import subprocess

import numpy as np
import pytest

from ntlink_tpu import cli as ref_cli
from ntlink_tpu import pipeline as ref
from ntlink_tpu.config import ScaffoldConfig as RefConfig
from ntlink_tpu_torch import cli, pipeline
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.seqio import stream_fastx

from .synthetic import assert_same_tree, write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
KW = dict(target="target.fa", reads=["reads.fa"], k=32, w=100, z=1000)


def write_fasta(path, records):
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")


def random_seq(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _flow_both(tmp_path, monkeypatch, write, gap_fill=False, scaffold=True,
               backend="auto"):
    """`write(d)` into two directories, then the port's flow on the CPU
    device in one (at `backend`) and ntlink_tpu's backend=numpy flow in the
    other; the directories must be equal. Returns the port's final path."""
    for side in ("torch", "numpy"):
        os.makedirs(tmp_path / side)
        write(tmp_path / side)
    monkeypatch.chdir(tmp_path / "numpy")
    rcfg = RefConfig(backend="numpy", **KW)
    want = (ref.scaffold_stage(rcfg) if scaffold
            else ref.run_scaffold(rcfg, gap_fill=gap_fill))
    monkeypatch.chdir(tmp_path / "torch")
    cfg = ScaffoldConfig(backend=backend, **KW)
    got = (pipeline.scaffold_stage(cfg, device="cpu") if scaffold
           else pipeline.run_scaffold(cfg, gap_fill=gap_fill, device="cpu"))
    assert got == want
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy",
                     ["target.fa.k32.w100.tsv"])
    return got


def test_no_mappable_reads_passthrough(tmp_path, monkeypatch):
    rng = random.Random(1)
    contigs = [("c1", random_seq(rng, 3000)), ("c2", random_seq(rng, 2500))]
    reads = [("r1", random_seq(rng, 2000))]

    def write(d):
        write_fasta(d / "target.fa", contigs)
        # reads unrelated to the target: no anchors, empty graph
        write_fasta(d / "reads.fa", reads)

    final = _flow_both(tmp_path, monkeypatch, write)
    out = {r.name: r.seq for r in stream_fastx(os.path.realpath(final))}
    # all contigs pass through unjoined
    assert {n.split()[0] for n in out} == {"c1", "c2"}
    assert sorted(out.values()) == sorted(s for _, s in contigs)
    assert pipeline.last_mapper.device_reads == 1


def test_contigs_shorter_than_k(tmp_path, monkeypatch):
    rng = random.Random(2)
    contigs = [("tiny", "ACGT"), ("c1", random_seq(rng, 3000))]
    reads = [("r1", random_seq(rng, 1500))]

    def write(d):
        write_fasta(d / "target.fa", contigs)
        write_fasta(d / "reads.fa", reads)

    # the contig sketch on the device alone (backend=jax), whose rows these
    # are
    final = _flow_both(tmp_path, monkeypatch, write, backend="jax")
    out = {r.name.split()[0] for r in stream_fastx(os.path.realpath(final))}
    assert out == {"tiny", "c1"}
    # the sub-k contig takes the exact host path, the other the device's
    sk = pipeline.last_sketcher
    assert (sk.host_fallbacks, sk.device_rows) == (1, 1)


def test_gap_fill_with_no_fillable_gaps(tmp_path, monkeypatch):
    rng = random.Random(3)
    contigs = [("c1", random_seq(rng, 3000))]
    reads = [("r1", random_seq(rng, 1500))]

    def write(d):
        write_fasta(d / "target.fa", contigs)
        write_fasta(d / "reads.fa", reads)

    out = _flow_both(tmp_path, monkeypatch, write, gap_fill=True,
                     scaffold=False)
    assert os.path.exists(out)
    assert os.path.exists(out + ".agp")


def test_empty_reads_file(tmp_path, monkeypatch):
    rng = random.Random(4)
    contigs = [("c1", random_seq(rng, 3000))]

    def write(d):
        write_fasta(d / "target.fa", contigs)
        open(d / "reads.fa", "w").close()

    final = _flow_both(tmp_path, monkeypatch, write)
    assert os.path.exists(os.path.realpath(final))
    assert pipeline.last_mapper.device_reads == 0


@pytest.mark.parametrize("case", ["all-N contig and read",
                                  "reads of k, k+1, k+w-2"])
def test_degenerate_rows_match_the_jax_package(tmp_path, monkeypatch, case):
    """The rows `chip_smoke.py` phase 14d adds to the cases above: an all-N
    contig and an all-N read (N batches whose rows hold no valid k-mer),
    and reads of k, k+1 and k+w-2 bases (rows with no full window)."""
    rng = random.Random(5)
    c1 = random_seq(rng, 3000)
    if case.startswith("all-N"):
        contigs = [("c1", c1), ("nn", "N" * 2000)]
        reads = [("r1", c1[100:2100]), ("rn", "N" * 1500)]
    else:
        contigs = [("c1", c1)]
        reads = [(f"r{n}", c1[500 : 500 + n]) for n in (32, 33, 130)]

    def write(d):
        write_fasta(d / "target.fa", contigs)
        write_fasta(d / "reads.fa", reads)

    # the contig sketch on the device alone (backend=jax): every contig row
    # is the device's
    _flow_both(tmp_path, monkeypatch, write, backend="jax")
    mapper, sketcher = pipeline.last_mapper, pipeline.last_sketcher
    # every row went through the device path, none to the exact host path
    assert mapper.device_reads == len(reads) and mapper.host_fallbacks == 0
    assert sketcher.device_rows == len(contigs)
    assert sketcher.host_fallbacks == 0


def test_cli_drop_in(tmp_path, monkeypatch):
    """`./ntLink_torch scaffold ... -B` as a user starts it (backend=numpy:
    no card is asked for), against ntlink_tpu's command line."""
    for side in ("torch", "numpy"):
        write_dataset(tmp_path / side, seed=95)
    argv = ["scaffold", "target=target.fa", "reads=reads.fa", "w=250",
            "backend=numpy", "-B"]
    proc = subprocess.run(
        [os.path.join(REPO, "ntLink_torch"), *argv], cwd=tmp_path / "torch",
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    final = "target.fa.k32.w250.z1000.ntLink.scaffolds.fa"
    assert (tmp_path / "torch" / final).exists()
    monkeypatch.chdir(tmp_path / "numpy")
    assert ref_cli.main(argv) == 0
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy", [final])


def test_non_conservative_mode_e2e(tmp_path, monkeypatch):
    """conservative=False stitches across the n-sweep outputs; on a clean
    draft it lays out what the conservative run does."""
    for side in ("torch", "numpy", "conservative"):
        write_dataset(tmp_path / side, seed=96)
    argv = ["scaffold", "target=target.fa", "reads=reads.fa", "k=24",
            "w=250", "z=1000"]
    paths = {}
    for side, extra in (("torch", ["conservative=False"]),
                        ("conservative", [])):
        monkeypatch.chdir(tmp_path / side)
        targets, cfg, rounds = cli.parse(argv + extra)
        assert cfg.conservative == (not extra)
        final = cli.dispatch(targets, cfg, rounds, "cpu")
        assert os.path.exists(os.path.realpath(final))
        with open(f"{cfg.resolved_prefix()}.stitch.path") as fh:
            paths[side] = sorted(l.rstrip("\n").split("\t")[1] for l in fh)
    assert paths["torch"] and paths["torch"] == paths["conservative"]
    monkeypatch.chdir(tmp_path / "numpy")
    assert ref_cli.main(argv + ["conservative=False", "backend=numpy"]) == 0
    assert_same_tree(tmp_path / "torch", tmp_path / "numpy",
                     ["target.fa.k24.w250.z1000.stitch.path"])


def test_native_chainer_many_distinct_contigs():
    """Reads hitting hundreds of distinct contigs chain exactly in the
    port's native chainer (its scratch grows with the contig count)."""
    from ntlink_tpu_torch.mapping import AnchorHit, chain_read_hits
    from ntlink_tpu_torch.native import chain_module

    mod = chain_module()
    assert mod is not None
    n = 600
    clen = np.full(n, 5000, np.int32)
    names = [f"c{i}" for i in range(n)]
    lengths = {names[i]: 5000 for i in range(n)}
    ch = mod.Chainer(clen, names)
    rng = np.random.default_rng(7)
    cids = rng.integers(0, n, size=n).astype(np.int32)
    cpos = rng.integers(0, 5000, size=n).astype(np.int32)
    rpos = np.sort(rng.integers(0, 4000, size=n)).astype(np.int32)
    sbits = rng.integers(0, 4, size=n).astype(np.int32)
    runs_raw, _ = ch.chain(cids, cpos, rpos, sbits, n, 4000, 32, 100, 0,
                           0.0, None)
    hits = [
        (names[c], AnchorHit(0, int(p), "+" if b & 1 else "-", int(r),
                             "+" if b & 2 else "-"))
        for c, p, r, b in zip(cids, cpos, rpos, sbits)
    ]
    expected = chain_read_hits(hits, 4000, lengths, k=32, z=100, x=0.0)
    assert len(runs_raw) == len(expected) > 0
    for got, run in zip(runs_raw, expected):
        assert names[got[0]] == run.contig and got[1] == run.hit_count


def test_unknown_parameter_fails_loudly():
    with pytest.raises(SystemExit, match="unknown parameter bogus_knob"):
        cli.build_config({"bogus_knob": "1"})


def test_main_keys_rejected_for_wrong_target():
    """rounds= only for run_rounds*, agp=/mappings=/out= only for
    liftover: anywhere else they fail loudly rather than silently no-op."""
    for key in ("out", "agp", "mappings", "rounds"):
        with pytest.raises(SystemExit, match="not valid for this target"):
            cli.build_config({key: "x"}, allowed_main=frozenset())
    cli.build_config({"rounds": "3"}, allowed_main=frozenset(("rounds",)))
    with pytest.raises(SystemExit, match="must be an integer"):
        cli.build_config({"rounds": "abc"},
                         allowed_main=frozenset(("rounds",)))
    # the command line takes rounds= only beside a rounds target, and
    # mappings= only with liftover
    with pytest.raises(SystemExit, match="not valid for this target"):
        cli.parse(["scaffold", "target=t.fa", "reads=r.fa", "rounds=2"])
    with pytest.raises(SystemExit, match="not valid for this target"):
        cli.main(["scaffold", "target=t.fa", "reads=r.fa", "mappings=m.tsv"])


def test_default_idx_shards_divides_device_count():
    from ntlink_tpu.device_map import default_idx_shards as ref_shards
    from ntlink_tpu_torch.device_map import default_idx_shards

    assert [default_idx_shards(n) for n in (1, 2, 3, 4, 6, 8, 12)] == \
        [1, 2, 1, 4, 2, 4, 4]
    for n in range(1, 33):
        s = default_idx_shards(n)
        assert n % s == 0 and (s & (s - 1)) == 0
        assert s == ref_shards(n)
