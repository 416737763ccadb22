"""The per-layer metrics that read the program's own keys and spans
(NTLINK_TIMING's split of the read stream's main thread, and the Tracer's
spans of the contig-index rebuild) read a number on the tiny stream and
index cells, run traced on the CPU, and the stream's shares of the main
thread add up."""
import pytest

from benchmark import harness
from benchmark.tests.tiny import run_tiny

STREAM = ("chain_render_share.stream", "tally_share.stream",
          "group_gather_share.stream", "read_prep_share.stream",
          "host_remap_share.stream", "reader_parse_share.stream",
          "main_unaccounted_share.stream")
INDEX = ("tsv_parse_s.index", "index_dedup_s.index", "table_upload_s.index",
         "sketch_render_s.index", "sketch_tail_s.index")


def _metrics(kind, names):
    spec = harness.benchmark_spec()
    cell = {"stream": "rice_ont_stream", "index": "rice_index_rounds"}[kind]
    per_layer = [m for m in spec["per_layer"] if cell in m["workloads"]]
    assert set(names) <= {m["name"] for m in per_layer}
    run, out = run_tiny(kind, trace=True, per_layer=per_layer)
    assert out["correct"], out["compared"]
    return run, {k: v["value"] for k, v in out["metrics"].items()}


def test_stream_shares_read_and_add_up():
    _, got = _metrics("stream", STREAM)
    for name in STREAM:
        assert name in got, name
        assert 0.0 <= got[name] <= 100.0, (name, got[name])
    for name in ("chain_render_share.stream", "tally_share.stream",
                 "group_gather_share.stream", "read_prep_share.stream",
                 "reader_parse_share.stream"):
        assert got[name] > 0.0, name
    # the main thread's shares, the old key's among them, are parts of
    # one wall; the new ones part of what the old metric left unkeyed
    main = [n for n in STREAM if n != "reader_parse_share.stream"]
    assert got["reader_pull_share.stream"] + sum(
        got[n] for n in main) <= 100.0 + 1e-6
    assert sum(got[n] for n in main) <= (
        got["producer_unkeyed_share.stream"] + 1e-6)


def test_index_spans_read_per_rebuild():
    run, got = _metrics("index", INDEX)
    for name in INDEX:
        assert name in got, name
        assert got[name] >= 0.0, (name, got[name])
    for name in ("tsv_parse_s.index", "index_dedup_s.index",
                 "table_upload_s.index"):
        assert got[name] > 0.0, name
    # the program's spans lie inside the harness's own clock around them
    assert got["tsv_parse_s.index"] + got["index_dedup_s.index"] <= (
        got["index_parse_s.index"])
    assert got["table_upload_s.index"] <= got["table_build_s.index"]
    assert len(run.counters["rebuilds"]) >= 1


def test_index_readers_read_nothing_without_spans():
    class Run:
        counters = {"rebuilds": [{}] * 10**6}

    for name in INDEX:
        assert harness.reader_for(name)(Run) is None


@pytest.mark.parametrize("name", STREAM)
def test_stream_readers_read_nothing_without_the_keys(name):
    """A program that times only the old keys (the stream before the
    consumer's keys existed) gives none of the new shares."""
    class Run:
        counters = {"stream_s": 2.0,
                    "timing": {"reader_pull": (0.5, 9), "pack": (0.1, 2),
                               "feed_enqueue_wait": (0.1, 2)}}

    assert harness.reader_for(name)(Run) is None
