"""The human cell, `human_3g_stream`, cut to a size the CPU runs in
seconds: a 600 kb genome with the configuration's four repeat groups, the
family counts cut with the length (and the segmental duplications' family
lengths, since 1,500 pairs of up to 400 kb alone outgrow 600 kb), and the
contig table forced into the load-4 regime that the full-size index takes
(an attribute lowered for the test only). Sound runs are correct; the
control and a planted fault are not; the two join readers read the
program's counts, and nothing where there are none."""
import copy

import pytest

from ntlink_tpu_torch import device_map, tracing
from ntlink_tpu_torch import mapping_step as ms

from benchmark import harness, trace
from benchmark.tests.test_bench_faults import _faulty_stream
from benchmark.tests.tiny import run_tiny, tiny_cell

CELL = "human_3g_stream"
READERS = ("join_GB_per_Gbase.stream", "join_roofline.stream")
#: the tiny cut's families in each repeat group, in the file's order
FAMILIES = [4, 10, 50, 2]
SMALL = 1_000


def tiny_human(per_layer=()) -> harness.Cell:
    """`tiny_cell`'s cut applied to the human configuration and the
    cell's own mix."""
    full = harness.load_cell(CELL)
    cell = tiny_cell("stream", per_layer)
    cfg = copy.deepcopy(full.config)
    cfg["control_key_bits"] = cell.config["control_key_bits"]
    cfg["genome"]["length"] = cell.config["genome"]["length"]
    for group, n in zip(cfg["genome"]["repeats"], FAMILIES):
        group["families"] = n
    cfg["genome"]["repeats"][3]["family_length"] = [1000, 20000]
    cfg["draft"]["n50"] = cell.config["draft"]["n50"]
    mix = copy.deepcopy(full.mix)
    for key in ("reads", "pass_bases", "sample_reads"):
        mix[key] = cell.mix[key]
    return harness.Cell("tiny_human", cfg, mix, cell.end_to_end,
                        list(per_layer))


@pytest.fixture
def human(monkeypatch):
    """`run_tiny` of the tiny human cell, with the load-4 table and the
    Tracer's state restored after the test."""
    monkeypatch.setattr(ms, "SMALL_TABLE_ENTRIES", SMALL)
    for name, value in (("enabled", False), ("spans", []), ("counts", [])):
        monkeypatch.setattr(tracing.GLOBAL, name, value)

    def run(per_layer=(), **kw):
        monkeypatch.setattr("benchmark.tests.tiny.tiny_cell",
                            lambda kind, pl=(): tiny_human(pl))
        return run_tiny("stream", per_layer=per_layer, **kw)
    return run


def test_the_cell_finds_its_files():
    cell = harness.load_cell(CELL)
    assert cell.config["name"] == "human_grch38_draft"
    # the 3.0 Gbp deployment, uncut
    assert cell.config["genome"]["length"] == 3_000_000_000
    assert cell.config["reduced"] == []
    assert len(cell.config["genome"]["repeats"]) == 4
    assert cell.chips == 1
    assert cell.mix["reads"]["median"] == 10000
    assert harness.driver_for(cell.mix) is not None
    assert {m["name"] for m in cell.end_to_end} == {"read_Mbase_per_s",
                                                   "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(READERS) <= names
    assert "producer_unkeyed_share.stream" not in names


def test_sound_run_is_correct_on_a_load4_table(human):
    run, out = human(trace=True, per_layer=[
        m for m in harness.benchmark_spec()["per_layer"]
        if m["name"] in READERS])
    assert out["correct"], out["compared"]
    assert out["parts"] == {"sampled_reads": 0, "tsv_contigs": 0,
                            "tally_pairs": 0, "passes": 0}
    (layout,) = tracing.GLOBAL.counts_named("table/build")
    assert layout["load"] == 4 and layout["entries"] > SMALL
    assert layout["max_probes"] >= 2
    # one join count a pass, warm passes included
    joins = tracing.GLOBAL.counts_named("map/join")
    n = run.counters["passes"]
    assert len(joins) == n + 2
    gb = out["metrics"]["join_GB_per_Gbase.stream"]["value"]
    assert gb == pytest.approx(sum(j["bucket_bytes"] for j in joins[-n:])
                               / run.counters["read_bases"])
    assert gb > 0
    # the CPU's trace has no kernels: the roofline reads a device trace
    assert "join_roofline.stream" not in out["metrics"]
    run.window_trace = trace.Trace(0.0, 1.0, [
        ("void at::native::vectorized_gather_kernel<16, long>(...)", 0.0,
         0.5, "kernel"), ("other_kernel", 0.0, 1.0, "kernel")])
    share = harness.reader_for("join_roofline.stream")(run)
    least = (run.counters["read_bases"] * 2 / 101 * 32
             / harness.load_json(harness.ROOT
                                 + "/benchmark/metrics/roofline.json")
             ["hbm_bytes_per_s"])
    assert share == pytest.approx(100 * least / 0.5)


def test_readers_read_nothing_without_counts(human, monkeypatch):
    run = harness.Run(tiny_human(), 1, 1.0, False, "/nonexistent")
    run.counters.update(passes=3, read_bases=10 ** 9)
    gb = harness.reader_for("join_GB_per_Gbase.stream")
    roof = harness.reader_for("join_roofline.stream")
    # the Tracer off: no counts; a Tracer that keeps none (an older
    # program): no method
    assert tracing.GLOBAL.counts_named("map/join") == []
    assert gb(run) is None
    monkeypatch.delattr(tracing.Tracer, "counts_named")
    assert gb(run) is None
    run.window_trace = None
    assert roof(run) is None
    run.window_trace = trace.Trace(0.0, 1.0, [("other", 0.0, 1.0,
                                               "kernel")])
    assert roof(run) is None


def test_control_is_incorrect(human):
    run, out = human(control=True)
    assert not out["correct"], out["parts"]
    assert out["parts"]["sampled_reads"] > 0


def test_altered_anchor_makes_the_run_incorrect(human, monkeypatch):
    monkeypatch.setattr(device_map.TorchMapper, "map_stream_raw",
                        _faulty_stream("altered"))
    run, out = human()
    assert not out["correct"], out["compared"]


def kernels_by_range(trace_path: str) -> dict:
    """{kernel name: {innermost device-side range around it (None for
    none): microseconds}} of one Chrome trace of the program's profile."""
    import json

    import numpy as np

    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"]
    ranges: dict = {}
    for e in events:
        if e.get("cat") == "gpu_user_annotation":
            ranges.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    arrays = {key: (np.array([r[0] for r in rs]), np.array([r[1] for r in rs]),
                    [r[2] for r in rs]) for key, rs in ranges.items()}
    out: dict = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = None
        if (e["pid"], e["tid"]) in arrays:
            a, b, names = arrays[(e["pid"], e["tid"])]
            inside = np.flatnonzero((a <= e["ts"] + 1e-3)
                                    & (b >= e["ts"] + e["dur"] - 1e-3))
            if len(inside):
                name = names[inside[np.argmin((b - a)[inside])]]
        by = out.setdefault(e["name"], {})
        by[name] = by.get(name, 0.0) + e["dur"]
    return out


@pytest.mark.cuda
def test_join_kernel_patterns_lie_inside_the_join(cuda_device, tmp_path,
                                                  monkeypatch):
    """One eager profile of a tiny human stream on the card (a profile
    directory on the Tracer, so the steps run eagerly inside their
    ranges): every kernel that ``join.json``'s patterns match runs inside
    ``mapping_step/join``, some do, and none outside it matches."""
    import re

    from benchmark.drivers import stream
    from ntlink_tpu_torch import pipeline

    monkeypatch.setattr(ms, "SMALL_TABLE_ENTRIES", SMALL)
    for name, value in (("enabled", True), ("spans", []), ("counts", []),
                        ("torch_profile_dir", str(tmp_path / "prof"))):
        monkeypatch.setattr(tracing.GLOBAL, name, value)
    run = harness.Run(tiny_human(), 271828182845, 1.0, False,
                      str(tmp_path), device=None)
    stream.make_data(run)
    cfg = stream.scaffold_config(run, run.path("reads.fq"))
    _, devices = pipeline.split_devices(cfg, None)
    with tracing.GLOBAL.stage("join-check"):
        tsv = pipeline.ensure_contig_sketch_tsv(cfg, cfg.k, cfg.w)
        index = pipeline.ContigIndex.from_tsv(tsv)
        lengths = pipeline.read_scaffold_lengths(cfg.target)
        mapper = pipeline.make_mapper(cfg, index, lengths, devices)
        assert mapper.graph_counts() is None or mapper.graph_counts()[1] == 0
        pipeline.map_reads(cfg, index, lengths, run.path("v.tsv"), None,
                           mapper)
    by = kernels_by_range(str(tmp_path / "prof" / "join-check" /
                              "trace.json"))
    join = harness.load_json(harness.ROOT + "/benchmark/metrics/join.json")
    rx = re.compile("|".join(join["table_gather"]))
    for kernel, ranges in sorted(by.items()):
        print(f"# kernel {kernel[:120]}: "
              + ", ".join(f"{r}: {us:.0f} us" for r, us in ranges.items()))
    matched = {k: r for k, r in by.items() if rx.search(k)}
    assert matched
    for kernel, ranges in matched.items():
        assert set(ranges) == {"mapping_step/join"}, (kernel, ranges)
    inside = {k for k, r in by.items() if "mapping_step/join" in r}
    assert inside & set(matched)


def test_sketch_pool_equals_the_threaded_sketch(tmp_path):
    """The pool's sketches, read from the FASTA by spawned workers, equal
    `judge.draft_sketches` on the draft in memory, contig for contig, on a
    draft with N runs and contigs shorter than a window; a FASTA laid out
    otherwise is refused."""
    import numpy as np

    from benchmark import gen, judge
    from benchmark.sketch_pool import draft_sketches

    cfg = tiny_cell("stream").config
    draft = gen.cut_draft(cfg, gen.make_genome(cfg, 1234567890123),
                          1234567890123)
    draft.names.append("short")
    draft.seqs.append(draft.seqs[0][:120].copy())
    assert any((s > 3).any() for s in draft.seqs)
    fasta = str(tmp_path / "target.fa")
    gen.write_fasta(fasta, draft.names, draft.seqs)
    lengths = [len(s) for s in draft.seqs]
    got = draft_sketches(fasta, draft.names, lengths, 32, 100,
                         str(tmp_path), processes=3)
    want = judge.draft_sketches(draft, 32, 100)
    assert len(got) == len(want) == len(draft.names)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert not list(tmp_path.glob("reference-sketch.*"))
    with pytest.raises(ValueError):
        draft_sketches(fasta, draft.names,
                       lengths[:-1] + [lengths[-1] + 1], 32, 100,
                       str(tmp_path))


def test_sampled_index_answers_as_the_whole_index():
    """The check's index over the sampled reads' keys gives every sampled
    read the lookups and the mapping of the whole draft's index, at the
    configuration's 64-bit keys and at the control's narrower ones, and
    refuses a key no sampled read holds."""
    import numpy as np

    from benchmark import gen, judge
    from benchmark.drivers import stream_pool
    from benchmark.reference import nthash, ntlink

    cell = tiny_human()
    cfg, mix = cell.config, cell.mix
    run = harness.Run(cell, 3141592653589, 1.0, False, "/nonexistent")
    genome = gen.make_genome(cfg, run.seed)
    draft = gen.cut_draft(cfg, genome, run.seed)
    reads = gen.make_reads(
        mix["reads"], gen.read_lengths(mix["reads"], mix["pass_bases"],
                                       cfg["name"], cell.name),
        genome, run.seed, cell.name)
    k, w, z = 32, 100, 1000
    sketches = judge.draft_sketches(draft, k, w)
    wanted = stream_pool.sampled_hashes(run, reads)
    picks = judge.sample(len(reads.names), int(mix["sample_reads"]),
                         run.seed, cell.name,
                         longest=judge.longest(reads.lengths, 5))
    for bits in (64, cfg["control_key_bits"]):
        whole = ntlink.Index(draft.names, sketches, key_bits=bits)
        part = stream_pool.SampledIndex(wanted, draft.names, sketches,
                                        key_bits=bits)
        assert 0 < len(part.keys) < len(whole.keys)
        for i in picks:
            h = nthash.sketch(reads.seq(i), k, w)[0]
            want, got = whole.lookup(h), part.lookup(h)
            found = want[0]
            assert np.array_equal(found, got[0]) and found.any()
            for a, b in zip(want[1:], got[1:]):
                assert np.array_equal(a[found], b[found])
            assert (ntlink.map_read(reads.seq(i), whole, draft.lengths, k,
                                    w, z)
                    == ntlink.map_read(reads.seq(i), part, draft.lengths,
                                       k, w, z))
        stranger = np.setdiff1d(np.concatenate([s[0] for s in sketches]),
                                wanted)[:1]
        assert part.holds(wanted).all()
        with pytest.raises(ValueError):
            part.lookup(stranger)
        if bits == 64:
            # a key that passes the bit table's screen but is not wanted
            twin = wanted[:1] ^ np.uint64(1 << 40)
            assert not part.holds(twin).any()
            with pytest.raises(ValueError):
                part.lookup(twin)
