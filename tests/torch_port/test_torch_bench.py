"""``ntlink_tpu_torch.bench`` (the port's measuring entry point) against the
repository's ``bench.py`` and ``ntlink_tpu``, on the CPU at a small size:
the dataset byte for byte, the weak host leg's tally, the three legs of
`device_run` against each other and against ``ntlink_tpu``'s backend=numpy
mapping, the result line's field names, and the exit without a device.
Inputs come from numpy seeds; every comparison is exact (integers and
strings)."""
import ast
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ntlink_tpu import pipeline as jax_pipeline
from ntlink_tpu.config import ScaffoldConfig as JaxConfig
from ntlink_tpu.index import ContigIndex as JaxIndex
from ntlink_tpu.ops import nthash_np as jax_nthash
from ntlink_tpu_torch import bench
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.seqio.fastx import stream_code_blocks

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SMALL = dict(n_contigs=4, contig_len=60_000, n_reads=300, read_len=5_000)


@pytest.fixture(scope="module")
def root_bench():
    """The repository's ``bench.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _contents(tally):
    """A tally of either package as {pair fields: (gaps, anchor)}."""
    return {dataclasses.astuple(pair): (list(ev.gap_estimates), ev.anchor)
            for pair, ev in tally.pairs.items()}


def test_constants_are_the_root_benchs(root_bench):
    for name in ("K", "W", "Z", "N_CONTIGS", "CONTIG_LEN", "GAP_LEN",
                 "N_READS", "READ_LEN", "ERR"):
        assert getattr(bench, name) == getattr(root_bench, name), name


@pytest.mark.parametrize("seed", [42, 7])
def test_make_dataset_is_byte_identical(root_bench, seed):
    kw = dict(n_contigs=3, contig_len=20_000, n_reads=80, read_len=3_000)
    got = bench.make_dataset(np.random.default_rng(seed), **kw)
    want = root_bench.make_dataset(np.random.default_rng(seed), **kw)
    assert got == want
    assert len(got[1]) == 80 and len(got[0]) == 3


def test_weak_leg_tally_matches_root_bench(root_bench):
    kw = dict(n_contigs=3, contig_len=40_000, n_reads=120, read_len=4_000)
    contigs, reads = bench.make_dataset(np.random.default_rng(5), **kw)
    lengths = {n: len(s) for n, s in contigs.items()}
    port_index = bench.ContigIndex.from_sketches(
        (n, bench.nthash_np.sketch_sequence(s, bench.K, bench.W))
        for n, s in contigs.items())
    jax_index = JaxIndex.from_sketches(
        (n, jax_nthash.sketch_sequence(s, bench.K, bench.W))
        for n, s in contigs.items())
    got = bench.run_mapping(contigs, reads, port_index, lengths,
                            ScaffoldConfig(k=bench.K, w=bench.W, z=bench.Z))
    want = root_bench.run_mapping(contigs, reads, jax_index, lengths,
                                  JaxConfig(k=bench.K, w=bench.W, z=bench.Z))
    assert got[:2] == want[:2] == (120, 120 * 4_000)
    assert _contents(got[2]) == _contents(want[2])
    assert len(got[2].pairs) > 0


def test_device_run_legs_match_each_other_and_the_jax_package(
        tmp_path, capfd, monkeypatch):
    """`device_run` on the CPU device: the device, hybrid and strong host
    tallies are equal, and equal ``ntlink_tpu``'s backend=numpy mapping of
    the same reads."""
    monkeypatch.setenv("NTLINK_TIMING", "1")
    workload = bench.build_workload(**SMALL)
    contigs, reads, lengths, _ = workload
    monkeypatch.setenv("NTLINK_BENCH_BATCH_BASES", "200000")
    fields, detail = bench.device_run("cpu", workload)
    tallies = detail["tallies"]
    assert set(tallies) == {"device", "hybrid", "host_strong"}
    assert tallies["device"] == tallies["hybrid"] == tallies["host_strong"]
    assert fields["pairs"] == fields["hybrid_pairs"] == len(tallies["device"])
    assert fields["pairs"] > 0
    # the JAX package's host path on the same reads
    reads_fa = tmp_path / "reads.fa"
    bench.write_reads(reads_fa, reads)
    jax_index = JaxIndex.from_sketches(
        (n, jax_nthash.sketch_sequence(s, bench.K, bench.W))
        for n, s in contigs.items())
    cfg = JaxConfig(k=bench.K, w=bench.W, z=bench.Z, reads=[str(reads_fa)],
                    backend="numpy", t=2)
    want = jax_pipeline.map_reads(cfg, jax_index, lengths, None, None)
    assert {dataclasses.astuple(p): v
            for p, v in tallies["device"].items()} == _contents(want)
    # the device leg's own accounting
    leg = detail["device_leg"]
    assert leg["runs"] == bench.DEVICE_RUNS == len(leg["seconds"])
    n_batches = leg["timing"]["dispatch"][1]
    # the reads file comes in blocks: one pull a block
    blocks = sum(1 for _ in stream_code_blocks(str(reads_fa),
                                               TorchMapper.BLOCK_BASES))
    assert n_batches > 1 and leg["timing"]["reader_pull"][1] == blocks
    pad = 8192
    assert leg["batches_by_pad"] == {
        (pad, False): bench.DEVICE_RUNS * n_batches}
    rows, rest = divmod(leg["wire_stats"]["h2d"], pad // 4 + 4)
    full = bench.DEVICE_RUNS * n_batches * 32  # 200,000 // 8192 -> 32 rows
    assert rest == 0 and full // 2 < rows <= full
    assert 0.0 < leg["stream_seconds"] <= leg["seconds"][-1]
    assert fields["wire_bytes_per_read_h2d"] == \
        leg["wire_stats"]["h2d"] // (bench.DEVICE_RUNS * 300)
    assert 0.0 < fields["wire_bound_fraction"] <= 1.0
    err = capfd.readouterr().err
    for want_line in ("# card: cpu", "# link: ", "# device[cpu]: 300 reads",
                      "# wire ceiling: ", "# timing [cpu]: producer thread",
                      "# timing [cpu]:   drain_decode",
                      "device busy share not measured",
                      "# hybrid[device+4 host threads]: 300 reads",
                      "# kernels: not measured"):
        assert want_line in err, want_line


def test_device_run_raises_when_a_leg_diverges(monkeypatch):
    """A leg whose tally differs fails the run: no "unavailable" line."""
    workload = bench.build_workload(**SMALL)
    real = bench.tally_contents
    calls = []

    def skewed(tally):
        out = real(tally)
        calls.append(1)
        if len(calls) == 3:  # device, hybrid, then the strong host leg
            out.pop(next(iter(out)))
        return out

    monkeypatch.setattr(bench, "tally_contents", skewed)
    monkeypatch.setattr(bench, "DEVICE_RUNS", 1)
    monkeypatch.setenv("NTLINK_BENCH_BATCH_BASES", "200000")
    with pytest.raises(AssertionError, match="host_strong leg"):
        bench.device_run("cpu", workload)


def _root_bench_fields():
    """Every constant field name that ``bench.py`` writes into its result
    line: string keys of dict literals, and of subscript stores, in
    `main`, `device_run` and `_kernel_bench`."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name in ("main", "device_run", "_kernel_bench")):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                names |= {k.value for k in node.keys
                          if isinstance(k, ast.Constant)
                          and isinstance(k.value, str)}
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.slice, ast.Constant)
                            and isinstance(t.slice.value, str)):
                        names.add(t.slice.value)
    # `main` pops the subprocess's rate and prints it as device_reads_per_s
    return names - {"reads_per_s"}


def test_result_line_has_the_root_benchs_field_names(capsys, monkeypatch):
    monkeypatch.setenv("NTLINK_BENCH_BATCH_BASES", "500000")
    monkeypatch.delenv("NTLINK_TIMING", raising=False)
    monkeypatch.setattr(bench, "DEVICE_RUNS", 2)
    monkeypatch.setattr(bench, "INTERLEAVED_RUNS", 2)
    rc = bench.main(["--device", "cpu", "--reads", "120", "--contigs", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    want = _root_bench_fields()
    assert {"metric", "value", "unit", "vs_baseline", "device_reads_per_s",
            "host_strong_reads_per_s", "host_weak_reads_per_s",
            "hybrid_reads_per_s", "wire_bound_fraction",
            "link_mbps_h2d"} <= want
    assert bench.NOT_PORTED_FIELDS <= want | {
        # built with an f-string in bench.py
        "sketch_xla_gbase_per_s", "sketch_pallas_gbase_per_s",
        "sketch_pallas_chunked_gbase_per_s"}
    assert want - bench.NOT_PORTED_FIELDS <= set(line)
    for leg in ("device", "hybrid", "host_strong_interleaved"):
        assert f"{leg}_median_reads_per_s" in line
    assert line["metric"] == "long_read_mapping_throughput"
    assert line["unit"] == "reads/s"
    assert line["reduced"] == {"reads": 120, "contigs": 3}
    assert line["device_kind"] == "cpu"
    assert line["pairs"] == line["hybrid_pairs"]
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / line["host_strong_reads_per_s"])
    assert line["value"] == max(line["device_reads_per_s"],
                                line["hybrid_reads_per_s"],
                                line["host_strong_reads_per_s"])


def test_without_a_device_main_exits_before_any_leg(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "build_workload", lambda **kw: 1 / 0)
    assert bench.main([]) == 1
    cap = capsys.readouterr()
    assert cap.out == ""
    assert "needs a CUDA device" in cap.err


def test_module_run_without_a_device_prints_no_result():
    res = subprocess.run(
        [sys.executable, "-m", "ntlink_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert res.returncode == 1
    assert res.stdout == ""
    assert "needs a CUDA device" in res.stderr


@pytest.mark.parametrize("argv", [["--reads", "30001"], ["--contigs", "17"],
                                  ["--reads", "0"]])
def test_sizes_only_shrink(argv):
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
