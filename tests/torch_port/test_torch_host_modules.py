"""The port's own copies of the host modules against ``ntlink_tpu``'s.

``ntlink_tpu_torch`` imports nothing of ``ntlink_tpu``: it carries its own
``ops/nthash_np.py``, ``native/`` (six C sources, built beside them),
``seqio``, ``index``, ``host_map`` and the rest. Both packages are loaded
in this one process, each with its own builds of the C modules, and the
same numpy-seeded inputs go through both: integers and bytes only, exact
equality.
"""
import gzip
import os

import numpy as np
import pytest

import ntlink_tpu.host_map as ref_host_map
import ntlink_tpu.index as ref_index
import ntlink_tpu.layout as ref_layout
import ntlink_tpu.liftover as ref_liftover
import ntlink_tpu.native as ref_native
import ntlink_tpu.ops.nthash_np as ref_nthash
import ntlink_tpu.seqio.fastx as ref_fastx
import ntlink_tpu.sketch as ref_sketch
import ntlink_tpu_torch.host_map as port_host_map
import ntlink_tpu_torch.index as port_index
import ntlink_tpu_torch.layout as port_layout
import ntlink_tpu_torch.liftover as port_liftover
import ntlink_tpu_torch.native as port_native
import ntlink_tpu_torch.ops.nthash_np as port_nthash
import ntlink_tpu_torch.seqio.fastx as port_fastx
import ntlink_tpu_torch.sketch as port_sketch
from ntlink_tpu import pipeline as ref_pipeline
from ntlink_tpu.config import ScaffoldConfig

from .synthetic import write_dataset

K, W, Z = 32, 100, 1000
MODULES = ("fastx", "chain", "graph", "liftover", "sketch", "tsv")


def _codes(seed, n, with_n=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    if with_n:
        codes[rng.integers(0, n, 5)] = 4
    return codes


def _same_minimizers(a, b):
    assert np.array_equal(a.hashes, b.hashes)
    assert np.array_equal(a.positions, b.positions)
    assert np.array_equal(a.forward, b.forward)
    assert a.hashes.dtype == b.hashes.dtype == np.uint64


@pytest.mark.parametrize("k,w", [(32, 100), (15, 5), (24, 250), (40, 100)])
def test_nthash_np_matches(k, w):
    for seed, n, with_n in ((1, 5000, False), (2, 3000, True), (3, k, False),
                            (4, k + w - 2, False), (5, k - 1, False)):
        codes = _codes(seed + k, n, with_n)
        _same_minimizers(ref_nthash.sketch_codes(codes, k, w),
                         port_nthash.sketch_codes(codes, k, w))
        a, b = ref_nthash.hash_kmers(codes, k), port_nthash.hash_kmers(codes, k)
        for field in a.__dataclass_fields__:
            assert np.array_equal(getattr(a, field), getattr(b, field)), field
    for a, b in zip(ref_nthash.srol_tables(k), port_nthash.srol_tables(k)):
        assert np.array_equal(a, b)
    assert ref_nthash.out_hash_multiplier(k) == port_nthash.out_hash_multiplier(k)
    seq = "ACGTNacgtnRYKM"
    assert np.array_equal(ref_nthash.encode(seq), port_nthash.encode(seq))


@pytest.mark.parametrize("name", MODULES)
def test_native_modules_are_each_packages_own(name):
    """Both builds load in one process under the same extension name, each
    from its own package directory, as two module objects."""
    ref = getattr(ref_native, f"{name}_module")()
    port = getattr(port_native, f"{name}_module")()
    assert ref is not None and port is not None
    assert ref is not port
    assert os.path.dirname(ref.__file__) == os.path.dirname(ref_native.__file__)
    assert os.path.dirname(port.__file__) == os.path.dirname(
        port_native.__file__)
    assert port.__name__ == ref.__name__ == f"ntlink_{name}"


@pytest.mark.parametrize("k,w", [(32, 100), (15, 5)])
def test_native_sketch_matches(k, w):
    ref, port = ref_native.sketch_module(), port_native.sketch_module()
    for seed, n, with_n in ((1, 40_000, False), (2, 9000, True), (3, k, False)):
        codes = _codes(seed, n, with_n)
        assert ref.sketch(codes, k, w) == port.sketch(codes, k, w)


def _index_and_reads(mod_index, mod_nthash):
    rng = np.random.default_rng(41)
    contigs = [rng.integers(0, 4, 120_000).astype(np.uint8) for _ in range(3)]
    index = mod_index.ContigIndex.from_sketches(
        (f"c{i}", mod_nthash.sketch_codes(c, K, W))
        for i, c in enumerate(contigs)
    )
    reads = []
    for r, n in enumerate([10, K + W - 1, 900, 5000, 12_000, 30_000, 45_000]):
        # the two longest switch contig half way: two runs
        c = contigs[r % 3]
        s = int(rng.integers(0, len(c) - n))
        read = c[s : s + n].copy()
        if n >= 30_000:
            read[n // 2 :] = contigs[(r + 1) % 3][s + n // 2 : s + n]
        err = rng.random(n) < 0.04
        read[err] = rng.integers(0, 4, err.sum())
        if r % 2:
            read = (3 - read)[::-1].copy()
        if r == 3:
            read[100] = 4
        reads.append((f"r{r}", read))
    clen = np.full(3, 120_000, np.int32)
    return index, reads, clen


def _same_raw(a, b):
    assert a[:2] == b[:2]
    if a[2] is None or b[2] is None:
        assert a[2] is None and b[2] is None
        return
    assert len(a[2]) == len(b[2])
    for x, y in zip(a[2], b[2]):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("mode", ["host-chained", "prechained", "runs"])
@pytest.mark.parametrize("threads", [1, 3])
def test_host_mapper_raw_matches(mode, threads):
    outs = []
    for host_map, index_mod, nthash in (
        (ref_host_map, ref_index, ref_nthash),
        (port_host_map, port_index, port_nthash),
    ):
        index, reads, clen = _index_and_reads(index_mod, nthash)
        mapper = host_map.HostMapper(
            index, K, W, threads=threads,
            prechain=None if mode == "host-chained" else (clen, Z),
            runs_only=mode == "runs",
        )
        assert mapper.prechained == (mode != "host-chained")
        assert mapper.runs_only == (mode == "runs")
        outs.append(list(mapper.map_stream_raw(iter(reads))))
    assert len(outs[0]) == len(outs[1]) == 7
    assert sum(raw is not None for _, _, raw in outs[0]) >= 4
    for a, b in zip(*outs):
        _same_raw(a, b)


@pytest.mark.parametrize("sensitive", [0, 1])
def test_native_chain_matches(sensitive):
    """`chain_select` and `chain_batch` (verbose + PAF rendering) of both
    builds on the same anchors."""
    index, reads, clen = _index_and_reads(ref_index, ref_nthash)
    raws = list(ref_host_map.HostMapper(index, K, W, threads=1)
                .map_stream_raw(iter(reads)))
    names, lens, parts = [], [], []
    for name, length, raw in raws:
        if raw is None:
            continue
        names.append(name)
        lens.append(length)
        parts.append(raw)
    offs = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([p[0] for p in parts], out=offs[1:])
    rpos, cid, cpos, sbits = (
        np.ascontiguousarray(np.concatenate([p[f] for p in parts]), np.int32)
        for f in (1, 2, 3, 4)
    )
    outs = []
    for native in (ref_native, port_native):
        chainer = native.chain_module().Chainer(clen, index.contig_names)
        p = parts[-1]
        sel = chainer.chain_select(
            *(np.ascontiguousarray(p[f], np.int32) for f in (2, 3, 1, 4)),
            lens[-1], K, Z, sensitive, 0.0,
        )
        batch = chainer.chain_batch(
            cid, cpos, rpos, sbits, offs, np.asarray(lens, np.int32), names,
            K, Z, sensitive, 0.0, 3, 0,
        )
        outs.append((bytes(sel), tuple(bytes(b) for b in batch)))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) > 0 and all(len(b) > 0 for b in outs[0][1])


def test_native_graph_matches():
    rng = np.random.default_rng(43)
    n = 400
    src = rng.integers(0, n - 1, 1500).astype(np.int32)
    dst = (src + rng.integers(1, 6, 1500)).clip(max=n - 1).astype(np.int32)
    outs = [
        bytes(bytearray(native.graph_module().transitive_reduce(
            n, src, dst, layout.MAX_TRANSITIVE_HOPS)))
        for native, layout in ((ref_native, ref_layout),
                               (port_native, port_layout))
    ]
    assert outs[0] == outs[1]
    assert 0 < sum(outs[0]) < len(src)


def _write_fasta(path, records, opener=open):
    with opener(path, "wt") as fh:
        for i, (name, seq) in enumerate(records):
            if i % 2:  # wrapped lines and a description
                fh.write(f">{name} some description\n")
                for at in range(0, len(seq), 70):
                    fh.write(seq[at : at + 70] + "\n")
            else:
                fh.write(f">{name}\n{seq}\n")


@pytest.mark.parametrize("gz", [False, True])
def test_fastx_reader_matches(tmp_path, gz):
    rng = np.random.default_rng(44)
    letters = np.array(list("ACGTNacgt"))
    records = [(f"s{i}", "".join(letters[rng.integers(0, 9, n)]))
               for i, n in enumerate([1, 69, 70, 71, 5000, 20_000])]
    path = str(tmp_path / ("x.fa.gz" if gz else "x.fa"))
    _write_fasta(path, records, gzip.open if gz else open)
    for native in (True, False):
        a = [(r.name, r.seq) for r in ref_fastx.stream_fastx(path, native)]
        b = [(r.name, r.seq) for r in port_fastx.stream_fastx(path, native)]
        assert a == b == records
    a, b = list(ref_fastx.stream_codes(path)), list(port_fastx.stream_codes(path))
    assert [n for n, _ in a] == [n for n, _ in b] == [n for n, _ in records]
    for (_, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype == np.uint8 and np.array_equal(x, y)
    assert ref_fastx.read_fasta_lengths(path) == port_fastx.read_fasta_lengths(
        path)
    # the C helpers of the device streams: 2-bit packing and TSV rendering
    rows = [np.where(c > 3, 0, c).astype(np.uint8) for _, c in a[3:]]
    ref, port = ref_native.fastx_module(), port_native.fastx_module()
    assert bytes(ref.pack_batch(rows, 32768)) == bytes(
        port.pack_batch(rows, 32768))
    mins = ref_nthash.sketch_codes(rows[-1], K, W)
    for with_strand in (True, False):
        assert ref_sketch.format_minimizers_bytes(mins, with_strand) == \
            port_sketch.format_minimizers_bytes(mins, with_strand)


@pytest.fixture(scope="module")
def scaffold_run(tmp_path_factory):
    """One `scaffold` run of ``ntlink_tpu`` on the host: its contig sketch
    TSV, verbose mapping and AGP feed the TSV parser and the liftover."""
    d = tmp_path_factory.mktemp("host_modules")
    write_dataset(d, seed=45, n_reads=80)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        ref_pipeline.run_scaffold(ScaffoldConfig(
            target="target.fa", reads=["reads.fa"], k=K, w=W, z=Z,
            backend="numpy"))
    finally:
        os.chdir(cwd)
    return d


def test_sketch_tsv_and_parser_match(scaffold_run, tmp_path):
    """The host sketch of a FASTA to the TSV artifact, then the C TSV
    parser behind `ContigIndex.from_tsv`."""
    target = str(scaffold_run / "target.fa")
    for threads in (1, 2):
        a, b = str(tmp_path / f"a{threads}.tsv"), str(tmp_path / f"b{threads}.tsv")
        ref_sketch.sketch_fasta_to_tsv(target, a, K, W, threads=threads)
        port_sketch.sketch_fasta_to_tsv(target, b, K, W, threads=threads)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert os.path.getsize(a) > 0
    ref, port = ref_index.ContigIndex.from_tsv(a), port_index.ContigIndex.from_tsv(a)
    assert ref.contig_names == port.contig_names
    assert len(ref) == len(port) > 0
    for field in ("hashes", "contig_ids", "positions", "strands"):
        assert np.array_equal(getattr(ref, field), getattr(port, field)), field
    hashes = np.concatenate([ref.hashes[::7], np.arange(5, dtype=np.uint64)])
    for x, y in zip(ref.lookup_many(hashes), port.lookup_many(hashes)):
        assert np.array_equal(x, y)


def test_liftover_matches(scaffold_run, tmp_path):
    stem = str(scaffold_run / f"target.fa.k{K}.w{W}.z{Z}")
    outs = []
    for liftover in (ref_liftover, port_liftover):
        out = str(tmp_path / f"{liftover.__name__}.tsv")
        liftover.liftover_mappings(f"{stem}.verbose_mapping.tsv",
                                   f"{stem}.trimmed_scafs.agp", out, K)
        with open(out, "rb") as fh:
            outs.append(fh.read())
    assert outs[0] == outs[1] and len(outs[0]) > 0
