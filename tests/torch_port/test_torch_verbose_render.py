"""The port's verbose rendering (``native/chain.c``: `render_verbose`, a
table-driven formatter that writes ``chain_batch``'s lines straight into
the bytes object it returns) against the JAX package's build of the same
source, which renders with ``sprintf``. Both ``Chainer.chain_batch``
(verbose, and verbose with PAF; host-chained and prechained) and
``Chainer.chain`` must give the same bytes on every case: the extremes of
``%d``, reads with one anchor and with none, a run of thousands of
anchors, a group of 1,024 reads, and names of 1 and 300+ bytes, in UTF-8
past ASCII, and with an embedded NUL, where ``%s`` stops. The stream's
``render/verbose`` count is checked against the verbose file it wrote, with
the Tracer on, and against nothing with it off."""
import os
import re

import numpy as np
import pytest

import ntlink_tpu.native as ref_native
import ntlink_tpu_torch.native as port_native
from ntlink_tpu_torch import pipeline, tracing
from ntlink_tpu_torch.config import ScaffoldConfig
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.index import ContigIndex

from .synthetic import write_dataset

K, Z = 32, 1000
#: every edge of %d: 0, the digit-count steps, the int32 extremes
POSITIONS = (0, 9, 10, 99, 100, 10**9, 2**31 - 1, -1, -2**31)
CONTIGS = ["c", "x" * 310, "контиг_é中", "ab\x00cd", "ctg_5", "short"]
#: the last contig falls under z, which host chaining filters out
LENGTHS = np.array([5_000, 200_000, 30_000, 40_000, 2**31 - 1, 500], np.int32)
READ_NAMES = ["r", "q" * 320, "读_ü", "rd\x00tail"]


def _group(reads):
    """chain_batch's inputs from a list of (name, read_len, cid, cpos,
    rpos, sbits) reads."""
    offs = np.zeros(len(reads) + 1, np.int64)
    offs[1:] = np.cumsum([len(r[2]) for r in reads])
    cols = [np.ascontiguousarray(np.concatenate(
        [np.asarray(r[f], np.int64) for r in reads] or [np.zeros(0)]),
        np.int32) for f in (2, 3, 4, 5)]
    lens = np.asarray([r[1] for r in reads], np.int32)
    return reads, cols, offs, lens


def _read(name, read_len, cid, cpos, rpos, sbits=None):
    n = len(cid)
    if sbits is None:
        sbits = [i % 4 for i in range(n)]
    return name, read_len, cid, cpos, rpos, sbits


def _positions():
    """Each read's anchors share one contig position, so host chaining's
    span filter keeps them; the read positions run through every value."""
    reads = []
    n = len(POSITIONS)
    for j, v in enumerate(POSITIONS):
        rp = [POSITIONS[(j + i) % n] for i in range(n + 3)]
        reads.append(_read(READ_NAMES[j % 4], 2**31 - 1,
                           [j % 5] * len(rp), [v] * len(rp), rp))
    # one anchor on each contig, every position once as each coordinate
    reads.append(_read("mixed", 2**31 - 1, [i % 5 for i in range(n)],
                       list(POSITIONS), list(reversed(POSITIONS))))
    return reads


def _one_and_none():
    return [
        _read("none_a", 100, [], [], []),
        _read("one", 15_000, [2], [-2**31], [2**31 - 1], [3]),
        _read("none_b", 100, [], [], []),
        _read("one_b", 15_000, [0], [0], [0], [0]),
        _read("none_c", 100, [], [], []),
    ]


def _long_run():
    rng = np.random.default_rng(5)
    n = 5_000
    cpos = np.sort(rng.integers(0, 190_000, n))
    rpos = np.sort(rng.integers(0, 190_000, n))
    # thousands of anchors in blocks that alternate two contigs
    blocks = np.repeat(np.arange(6) % 2, 700)[:4_000]
    return [
        _read("long", 200_000, [1] * n, cpos, rpos,
              rng.integers(0, 4, n)),
        _read("blocks", 200_000, np.where(blocks, 1, 4), np.arange(4_000),
              np.arange(4_000)[::-1], rng.integers(0, 4, 4_000)),
    ]


def _group_1024():
    rng = np.random.default_rng(7)
    reads = []
    for i in range(1_024):
        n = int(rng.integers(0, 60))
        rl = int(rng.integers(5_000, 40_000))
        reads.append(_read(
            f"{READ_NAMES[i % 4]}{i}", rl,
            np.sort(rng.integers(0, len(CONTIGS), n)) if i % 3 else
            rng.integers(0, len(CONTIGS), n),
            rng.integers(0, rl, n), rng.integers(0, rl, n),
            rng.integers(0, 4, n)))
    return reads


def _names():
    reads = []
    for i, name in enumerate(READ_NAMES + ["é" * 200]):
        cid = [c for c in range(len(CONTIGS)) for _ in range(3)]
        reads.append(_read(name, 10_000, cid, [i * 7 + j for j in
                                               range(len(cid))],
                           [j * 11 for j in range(len(cid))]))
    return reads


CASES = {"positions": _positions, "one_and_none": _one_and_none,
         "long_run": _long_run, "group_1024": _group_1024, "names": _names}


def _chainers():
    return [native.chain_module().Chainer(LENGTHS, CONTIGS)
            for native in (ref_native, port_native)]


@pytest.mark.parametrize("mode", [1, 3])
@pytest.mark.parametrize("prechained", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_verbose_bytes_match_sprintf_build(case, prechained, mode):
    reads, (cid, cpos, rpos, sbits), offs, lens = _group(CASES[case]())
    names = [r[0] for r in reads]
    batches = [
        tuple(b if b is None else bytes(b) for b in chainer.chain_batch(
            cid, cpos, rpos, sbits, offs, lens, names, K, Z, sensitive, 0.0,
            mode, prechained))
        for sensitive in (0, 1) for chainer in _chainers()
    ]
    # both builds, host chaining specific and sensitive
    assert batches[0] == batches[1] and batches[2] == batches[3]
    verbose = batches[0][2]
    assert verbose.count(b"\n") >= 1
    assert (batches[0][3] is None) == (mode == 1)
    if mode == 3:
        assert len(batches[0][3]) > 0
    if case == "positions":
        for v in POSITIONS:
            assert f"{v}:".encode() in verbose and f"_{v}:".encode() in verbose
    if case == "names":
        # %s stops at the NUL; the bytes after it never appear
        assert b"rd\tab\t" in verbose and b"tail" not in verbose
        assert b"\tcd" not in verbose and "读_ü".encode() in verbose
    # the per-read entry point (host chaining) renders with the same
    # formatter
    sensitive = mode == 3
    for name, read_len, *cols in reads:
        arrays = [np.ascontiguousarray(c, np.int32) for c in cols]
        got = [chainer.chain(*arrays, len(arrays[0]), read_len, K, Z,
                             sensitive, 0.0, name)
               for chainer in _chainers()]
        assert got[0] == got[1]


def _anchors_and_bytes(path):
    with open(path, "rb") as fh:
        data = fh.read()
    anchors = 0
    for line in data.splitlines():
        _, _, count, hits = line.split(b"\t")
        assert int(count) == len(hits.split(b" "))
        anchors += int(count)
    return anchors, len(data)


@pytest.fixture(scope="module")
def tiny_stream(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("render"))
    write_dataset(d, seed=31, n_reads=1_100, read_len=(1_500, 4_000))
    cfg = ScaffoldConfig(target=f"{d}/target.fa", reads=[f"{d}/reads.fa"],
                         k=K, w=100, z=Z, t=2, batch_bases=200_000,
                         verbose=True)
    tsv = pipeline.ensure_contig_sketch_tsv(cfg, K, 100, device="cpu")
    return d, cfg, ContigIndex.from_tsv(tsv), pipeline.read_scaffold_lengths(
        cfg.target)


@pytest.mark.parametrize("enabled", [True, False])
def test_render_count_equals_the_verbose_file(tiny_stream, enabled,
                                              monkeypatch, capfd):
    d, cfg, index, lengths = tiny_stream
    for name, value in (("enabled", enabled), ("spans", []), ("counts", [])):
        monkeypatch.setattr(tracing.GLOBAL, name, value)
    mapper = pipeline.make_mapper(cfg, index, lengths, ["cpu"])
    assert isinstance(mapper, TorchMapper) and mapper.prechained
    capfd.readouterr()
    path = os.path.join(d, f"verbose.{enabled}.tsv")
    pipeline.map_reads(cfg, index, lengths, path, None, mapper)
    anchors, nbytes = _anchors_and_bytes(path)
    assert anchors > 1_000 and nbytes > 0
    summary = re.findall(r"verbose rendering: (\d+) anchors, (\d+) bytes;",
                         capfd.readouterr().err)
    counts = tracing.GLOBAL.counts_named("render/verbose")
    if not enabled:
        assert counts == [] and summary == []
        return
    # one count a stream, on the stream's summary line too
    assert counts == [{"anchors": anchors, "bytes": nbytes}]
    assert summary == [(str(anchors), str(nbytes))]
