"""The port's own measurement of the read stream and of the contig-index
rebuild: NTLINK_TIMING's keys of the stream's main thread and of its
reader thread, through the native and the runs-only consumers of
`pipeline.map_reads`; the Tracer's nested spans of the rebuild (v=1); and
the ``ntlink/`` `record_function` ranges that put both on a torch
profile's clock. With both switches off, none of it records anything."""
import io
import json
import math
import os
import time

import numpy as np
import pytest
import torch

from ntlink_tpu_torch import pipeline, tracing
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.index import ContigIndex
from ntlink_tpu_torch.seqio.fastx import stream_code_blocks
from ntlink_tpu_torch.sketch import TorchHybridSketcher
from ntlink_tpu_torch.stream_pipeline import PhaseTimer

from .synthetic import write_dataset

GROUP = 7
NATIVE = ("group_gather", "chain_render", "verbose_write", "tally")
INDEX_SPANS = ("contig-sketch/render", "index/read", "index/parse",
               "index/dedup", "table/build", "table/upload")


@pytest.fixture
def tracer(monkeypatch):
    """The process-wide tracer, off and empty, put back afterwards."""
    monkeypatch.setattr(tracing.GLOBAL, "enabled", False)
    monkeypatch.setattr(tracing.GLOBAL, "spans", [])
    monkeypatch.setattr(tracing.GLOBAL, "torch_profile_dir", None)
    return tracing.GLOBAL


def _draft(d, n_reads=40):
    """`write_dataset`'s draft and reads, and one read shorter than k,
    which the mapper sends to the exact host path; returns the read count."""
    write_dataset(d, seed=23, n_reads=n_reads)
    with open(os.path.join(d, "reads.fa"), "a") as fh:
        fh.write(">sub_k\nACGTACGTACGT\n")
    with open(os.path.join(d, "reads.fa")) as fh:
        return sum(line.startswith(">") for line in fh)


def _cfg(d, **kw):
    return ScaffoldConfig(target=os.path.join(d, "target.fa"),
                          reads=[os.path.join(d, "reads.fa")], k=32, w=100,
                          z=1000, t=4, batch_bases=200_000, **kw)


def _rebuild(cfg):
    """`pair_stage`'s contig index and mapper on the CPU device."""
    tsv = pipeline.ensure_contig_sketch_tsv(cfg, cfg.k, cfg.w, device="cpu")
    index = ContigIndex.from_tsv(tsv)
    lengths = pipeline.read_scaffold_lengths(cfg.target)
    return index, lengths, pipeline.make_mapper(cfg, index, lengths, ["cpu"])


@pytest.mark.parametrize("consumer", ["native", "runs only"])
def test_stream_keys_through_the_consumers(consumer, tmp_path, monkeypatch,
                                           tracer):
    monkeypatch.setenv("NTLINK_TIMING", "1")
    monkeypatch.setattr(pipeline, "CHAIN_GROUP", GROUP)
    n = _draft(str(tmp_path))
    native = consumer == "native"
    cfg = _cfg(str(tmp_path), verbose=native)
    index, lengths, mapper = _rebuild(cfg)
    assert mapper.runs_only is not native
    wall0 = mapper.stream_seconds
    pipeline.map_reads(cfg, index, lengths,
                       str(tmp_path / "verbose.tsv") if native else None,
                       None, mapper)
    wall = mapper.stream_seconds - wall0
    timing = mapper.last_timing
    want = {"read_prep", "host_remap", "flush_join", "reader_parse", "tally"}
    assert want <= set(timing), want - set(timing)
    assert set(timing) <= {k for keys in PhaseTimer.THREADS.values()
                           for k in keys}
    # the reader hands the reads over in blocks: one parse and one pull a
    # block, and one read_prep span a read delivered
    blocks = sum(1 for _ in stream_code_blocks(cfg.reads[0],
                                               TorchMapper.BLOCK_BASES))
    for key in ("reader_pull", "reader_parse"):
        assert timing[key][1] == blocks, key
    assert timing["read_prep"][1] == n
    assert timing["host_remap"][1] >= 1
    if native:
        # one span per group, the last group's (after the stream's last
        # read) in the stream's split too; a group that renders nothing
        # writes nothing
        groups = math.ceil(n / GROUP)
        for key in ("group_gather", "chain_render", "tally"):
            assert timing[key][1] == groups, key
        assert 0 < timing["verbose_write"][1] <= groups
    else:
        assert not set(NATIVE[:3]) & set(timing)
        assert 0 < timing["tally"][1] < n
    for thread, keys in PhaseTimer.THREADS.items():
        total = sum(timing[k][0] for k in keys if k in timing)
        assert total <= wall, (thread, total, wall)
    # the CPU seconds beside the wall: of the keys timed at most once per
    # batch, flush, remap or group (the runs-only consumer's tally is per
    # read), and of the producer's and the reader's whole thread; a CPU
    # reading cannot pass its wall by more than the two clocks' skew
    cpu = mapper.last_cpu
    per_read = {"reader_pull", "read_prep", "reader_parse", "h2d_put",
                "drain_flat_wait"} | (set() if native else {"tally"})
    assert set(cpu) == set(timing) - per_read
    for key, secs in cpu.items():
        assert -1e-3 <= secs <= timing[key][0] + 1e-3, key
    threads = mapper.last_thread_cpu
    assert set(threads) == {"producer", "reader"}
    assert 0 < threads["producer"] <= wall + 1e-3
    assert 0 < threads["reader"]


def test_stream_wall_takes_in_the_consumers_last_group(tmp_path, monkeypatch,
                                                       tracer):
    """The consumer's last group runs after the stream's last read: its
    time is inside the stream's wall and split all the same."""
    monkeypatch.setenv("NTLINK_TIMING", "1")
    monkeypatch.setattr(pipeline, "CHAIN_GROUP", 10**6)   # one group
    _draft(str(tmp_path))
    cfg = _cfg(str(tmp_path), verbose=True)
    index, lengths, mapper = _rebuild(cfg)
    real = pipeline._make_native_chainer

    class Slow:
        def __init__(self, chainer):
            self.chainer = chainer

        def chain_batch(self, *args):
            time.sleep(0.3)
            return self.chainer.chain_batch(*args)

    monkeypatch.setattr(pipeline, "_make_native_chainer",
                        lambda *a: Slow(real(*a)))
    wall0 = mapper.stream_seconds
    pipeline.map_reads(cfg, index, lengths, str(tmp_path / "v.tsv"), None,
                       mapper)
    assert mapper.last_timing["chain_render"][1] == 1
    assert mapper.last_timing["chain_render"][0] >= 0.3
    assert mapper.stream_seconds - wall0 >= 0.3


def _busy(seconds):
    t = time.thread_time()
    while time.thread_time() - t < seconds:
        pass


def test_cpu_tells_work_from_waits():
    """CPU seconds tell a thread's work apart from its waits: a sleep reads
    its wall and next to no CPU, a busy loop both, in a key timed by
    `mark` or `span` and in a thread's whole reading; the per-read
    `timed` and `self_timed` read no CPU clock."""
    timer = PhaseTimer(True)
    c0 = timer.cpu_now()
    ts = timer.now()
    time.sleep(0.05)
    ts = timer.mark("wait", ts)
    _busy(0.05)
    timer.mark("work", ts)
    with timer.span("group"):
        time.sleep(0.02)
        _busy(0.02)
    assert list(timer.timed(iter(range(4)), "pull")) == [0, 1, 2, 3]
    assert list(timer.self_timed((i for i in range(3)), "own", ())) == [
        0, 1, 2]
    timer.thread_cpu_since("producer", c0)
    wall = {k: s for k, (s, _) in timer.acc.items()}
    cpu = timer.cpu
    assert set(cpu) == {"wait", "work", "group"}
    assert wall["wait"] >= 0.05 and cpu["wait"] < 0.01
    assert 0.05 <= cpu["work"] <= wall["work"] + 1e-3
    assert 0.02 <= cpu["group"] and wall["group"] >= 0.04
    assert timer.acc["own"][1] == 3 and timer.acc["pull"][1] == 4
    # the thread: both busy loops, neither sleep
    assert 0.07 <= timer.thread_cpu["producer"] < 0.1
    assert timer.cpu_line() == "# ntlink cpu: " + " ".join(
        [f"{k}={cpu[k]:.3f}s" for k in sorted(cpu)] + ["threads"]
        + [f"producer={timer.thread_cpu['producer']:.3f}s"])


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_switches_and_ranges(on, tmp_path, monkeypatch, tracer):
    """Off (NTLINK_TIMING unset, the tracer off), nothing records and no
    ``ntlink/`` range opens under a running profiler; on, the group keys
    and the spans open their ranges, and the per-read keys none."""
    if on:
        monkeypatch.setenv("NTLINK_TIMING", "1")
        monkeypatch.setattr(tracer, "enabled", True)
    else:
        monkeypatch.delenv("NTLINK_TIMING", raising=False)
    _draft(str(tmp_path))
    cfg = _cfg(str(tmp_path), verbose=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        index, lengths, mapper = _rebuild(cfg)
        pipeline.map_reads(cfg, index, lengths, str(tmp_path / "v.tsv"),
                           None, mapper)
    ranges = {e.name for e in prof.events()
              if e.name.startswith(tracing.RANGE_PREFIX)}
    if not on:
        assert mapper.last_timing == {} and mapper.last_cpu == {}
        assert mapper.last_thread_cpu == {}
        assert tracer.spans == []
        assert ranges == set()
        return
    want = {f"ntlink/{k}" for k in NATIVE + INDEX_SPANS
            if k != "contig-sketch/render"}
    assert want <= ranges, want - ranges
    # per-read keys and a span summed from pieces open none
    assert not {f"ntlink/{k}" for k in ("read_prep", "reader_pull",
                                        "reader_parse", "pack",
                                        "contig-sketch/render")} & ranges


def test_index_spans_once_per_rebuild(tmp_path, tracer, monkeypatch):
    """Each rebuild (`ensure_contig_sketch_tsv`, `from_tsv`, `make_mapper`)
    records each of its spans once; the parse's three lie within
    `from_tsv`'s wall; the hybrid contig sketch's paths have a span each,
    and the tail between their ends."""
    monkeypatch.setattr(tracer, "enabled", True)
    rng = np.random.default_rng(5)
    with open(tmp_path / "target.fa", "w") as fh:
        for i in range(300):   # several blocks of HYBRID_BLOCK_ITEMS
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))
            fh.write(f">c{i}\n{seq}\n")
    cfg = _cfg(str(tmp_path))
    for rebuild in range(2):
        n0 = len(tracer.spans)
        tsv = pipeline.ensure_contig_sketch_tsv(cfg, cfg.k, cfg.w,
                                                device="cpu")
        sk = pipeline.last_sketcher
        assert isinstance(sk, TorchHybridSketcher)
        t0 = time.time_ns()
        index = ContigIndex.from_tsv(tsv)
        parse_s = (time.time_ns() - t0) / 1e9
        pipeline.make_mapper(cfg, index, {f"c{i}": 3000 for i in range(300)},
                             ["cpu"])
        spans = tracer.spans[n0:]
        names = [s.name for s in spans]
        for name in INDEX_SPANS + ("contig-sketch/tail",):
            assert names.count(name) == 1, (rebuild, name, names)
        by = {s.name: s for s in spans}
        assert sum(by[f"index/{p}"].wall_s
                   for p in ("read", "parse", "dedup")) <= parse_s
        assert all(s.parent is None and s.thread for s in spans)
        ends = []
        for path, bases in (("card", sk.device_bases),
                            ("host", sk.host_bases)):
            assert bases > 0, path
            span = by[f"contig-sketch/{path}"]
            ends.append(span.start_ns + span.wall_s * 1e9)
        tail = by["contig-sketch/tail"]
        assert tail.start_ns == pytest.approx(min(ends), abs=1e5)
        assert tail.wall_s == pytest.approx((max(ends) - min(ends)) / 1e9,
                                            abs=1e-4)
        os.remove(tsv)


def test_nested_spans(tmp_path):
    t = tracing.Tracer(enabled=True, torch_profile_dir=str(tmp_path / "p"))
    with t.stage("outer"):
        with t.stage("mid"):
            with t.stage("inner"):
                time.sleep(0.01)
        with t.stage("mid2"):
            pass
        t.add("summed", time.time_ns(), 0.5)
    with t.stage("second"):
        pass
    by = {s.name: s for s in t.spans}
    assert by["outer"].parent is None and by["second"].parent is None
    assert by["mid"].parent == "outer" and by["mid2"].parent == "outer"
    assert by["inner"].parent == "mid" and by["summed"].parent == "outer"
    assert all(s.thread == "MainThread" for s in t.spans)
    assert by["outer"].start_ns <= by["mid"].start_ns <= by["inner"].start_ns
    # a per-stage profile for the top-level spans alone
    assert sorted(os.listdir(tmp_path / "p")) == ["outer", "second"]
    with open(tmp_path / "p" / "outer" / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"ntlink/outer", "ntlink/mid", "ntlink/inner"} <= names
    # the report: by start, nested spans indented, top-level total
    buf = io.StringIO()
    t.report(buf)
    lines = buf.getvalue().splitlines()[2:]
    assert [ln.split()[0] for ln in lines] == [
        "outer", "mid", "inner", "mid2", "summed", "second", "TOTAL"]
    assert [len(ln) - len(ln.lstrip()) for ln in lines] == [
        2, 4, 6, 4, 4, 2, 2]
    total = float(lines[-1].split()[2].rstrip("s"))
    assert total == pytest.approx(
        by["outer"].wall_s + by["second"].wall_s, abs=0.006)
    # the JSON keeps the old fields and has the new ones beside them
    t.write_json(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as fh:
        rows = json.load(fh)
    assert [r["name"] for r in rows] == [ln.split()[0] for ln in lines[:-1]]
    for r in rows:
        assert set(r) == {"name", "wall_s", "cpu_s", "max_rss_kb",
                          "start_ns", "parent", "thread"}


def test_span_start_is_on_the_profilers_clock(tmp_path):
    """A span's `start_ns` and its range's ``ts`` plus the trace's
    ``baseTimeNanoseconds`` agree within 2 ms, and so do their lengths.
    Five spans: on a loaded host the process can be descheduled between
    the range's clock read and the span's, so the median of the five is
    held to the 2 ms."""
    t = tracing.Tracer(enabled=True)
    names = [f"clock{i}" for i in range(5)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        time.sleep(0.05)
        for name in names:
            with t.stage(name):
                time.sleep(0.02)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as fh:
        trace = json.load(fh)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    starts, lengths = [], []
    for span in t.spans:
        ev = [e for e in trace["traceEvents"]
              if e.get("name") == "ntlink/" + span.name]
        assert len(ev) == 1, span.name
        starts.append(abs(ev[0]["ts"] + base_us - span.start_ns / 1e3))
        lengths.append(abs(ev[0]["dur"] / 1e6 - span.wall_s))
    assert [s.name for s in t.spans] == names
    assert sorted(starts)[2] < 2000.0, starts
    assert sorted(lengths)[2] < 2e-3, lengths
