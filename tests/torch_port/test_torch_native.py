"""The port's native C modules (its copies of ``native/chain.c``,
``sketch.c`` and ``fastxio.c``) against its own Python paths, after
``tests/test_native_chain.py``, ``tests/test_native_sketch.py`` and the
golden-free tests of ``tests/test_native_io.py``:

- the chainer equals `mapping.chain_read_hits` (runs and verbose text) in
  both modes and at two x, and `chain_batch` equals per-read calls;
- the sketcher equals `ops.nthash_np` at seven (k, w) shapes with N, gives
  nothing for an all-N row, the log-doubling hasher equals the gather
  reference, `sketch_join` equals sketch + `ContigIndex.lookup_many`, and
  `HostMapper`'s raw payloads equal `TorchMapper`'s on the CPU device, from
  its device path and from its exact host path, N reads included;
- the FASTA/FASTQ reader equals the Python parser on the synthetic draft,
  its reads as gzipped FASTQ and as line-wrapped gzipped FASTA (in place of
  the reference's files) and on odd records, and equals ntlink_tpu's
  reader; `stream_codes` equals `encode`; the parallel file prefetch keeps
  file order, raises a worker's error and releases its workers when
  abandoned; the minimizer TSV renderer equals the Python formatter.
Exact comparison everywhere."""
import gzip
import threading
import time

import numpy as np
import pytest

from ntlink_tpu.seqio import stream_fastx as ref_stream_fastx
from ntlink_tpu_torch.mapping import AnchorHit, chain_read_hits
from ntlink_tpu_torch.native import chain_module, sketch_module
from ntlink_tpu_torch.ops import nthash_np as nt
from ntlink_tpu_torch.seqio import stream_fastx
from ntlink_tpu_torch.seqio.fastx import (
    _parse, open_text_maybe_gzip, prefetch_files, stream_codes,
)

from .synthetic import write_dataset


# ---- after tests/test_native_chain.py ----

def _hits(names, cid, cpos, rpos, sbits):
    return [
        (names[c], AnchorHit(0, int(p), "+" if b & 1 else "-", int(r),
                             "+" if b & 2 else "-"))
        for c, p, r, b in zip(cid, cpos, rpos, sbits)
    ]


@pytest.mark.parametrize("sensitive", [False, True])
@pytest.mark.parametrize("x", [0.0, 1.5])
def test_chainer_matches_python(sensitive, x):
    mod = chain_module()
    assert mod is not None
    rng = np.random.default_rng(int(sensitive) * 2 + int(x))
    n_contigs = 6
    names = [f"ctg{i}" for i in range(n_contigs)]
    clen = rng.integers(400, 6000, size=n_contigs).astype(np.int32)
    lengths = {names[i]: int(clen[i]) for i in range(n_contigs)}
    chainer = mod.Chainer(clen, names)
    for trial in range(200):
        n = int(rng.integers(1, 40))
        cid = rng.integers(0, n_contigs, size=n).astype(np.int32)
        cpos = rng.integers(0, 6000, size=n).astype(np.int32)
        rpos = np.sort(rng.integers(0, 4000, size=n)).astype(np.int32)
        sbits = rng.integers(0, 4, size=n).astype(np.int32)
        read_len = int(rng.integers(500, 5000))
        expected = chain_read_hits(
            _hits(names, cid, cpos, rpos, sbits), read_len, lengths, k=32,
            z=1000, x=x, sensitive=sensitive,
        )
        runs_raw, vbytes = chainer.chain(
            cid, cpos, rpos, sbits, n, read_len, 32, 1000,
            1 if sensitive else 0, x, "r%d" % trial,
        )
        assert len(runs_raw) == len(expected), f"trial {trial}"
        exp_verbose = "".join(
            f"r{trial}\t{run.contig}\t{run.hit_count}\t{run.hits_string()}\n"
            for run in expected
        )
        got_verbose = vbytes.decode() if vbytes is not None else ""
        assert got_verbose == exp_verbose, f"trial {trial}"
        for got, run in zip(runs_raw, expected):
            c, cnt, fc, fr, fb, lc, lr, lb = got
            assert names[c] == run.contig
            assert cnt == run.hit_count
            assert (fc, fr) == (run.first_hit.ctg_pos, run.first_hit.read_pos)
            assert (lc, lr) == (run.terminal_hit.ctg_pos,
                                run.terminal_hit.read_pos)


@pytest.mark.parametrize("sensitive", [False, True])
def test_chain_batch_matches_per_read(sensitive):
    """chain_batch over a random group == per-read chain calls, the
    concatenated verbose blob and reads without anchors included."""
    mod = chain_module()
    assert mod is not None
    rng = np.random.default_rng(11 + int(sensitive))
    n_contigs = 8
    names = [f"ctg{i}" for i in range(n_contigs)]
    clen = rng.integers(400, 6000, size=n_contigs).astype(np.int32)
    chainer = mod.Chainer(clen, names)
    n_reads = 120
    per_read, read_lens = [], []
    for _ in range(n_reads):
        n = int(rng.integers(0, 30))  # some reads have zero anchors
        per_read.append((
            rng.integers(0, n_contigs, size=n).astype(np.int32),
            rng.integers(0, 6000, size=n).astype(np.int32),
            np.sort(rng.integers(0, 4000, size=n)).astype(np.int32),
            rng.integers(0, 4, size=n).astype(np.int32),
        ))
        read_lens.append(int(rng.integers(500, 5000)))
    offs = np.zeros(n_reads + 1, np.int64)
    for i, (cid, _, _, _) in enumerate(per_read):
        offs[i + 1] = offs[i] + len(cid)
    rnames = [f"read{i}" for i in range(n_reads)]
    runs_b, ro_b, vbytes, _paf = chainer.chain_batch(
        *(np.concatenate([p[j] for p in per_read]).astype(np.int32)
          for j in range(4)),
        offs, np.asarray(read_lens, np.int32), rnames,
        32, 1000, 1 if sensitive else 0, 0.5,
    )
    runs_arr = np.frombuffer(runs_b, np.int32).reshape(-1, 8)
    ro = np.frombuffer(ro_b, np.int32)
    assert ro[0] == 0 and ro[-1] == runs_arr.shape[0]
    exp_verbose = b""
    for i, (cid, cpos, rpos, sbits) in enumerate(per_read):
        exp_runs, exp_v = chainer.chain(
            cid, cpos, rpos, sbits, len(cid), read_lens[i], 32, 1000,
            1 if sensitive else 0, 0.5, rnames[i],
        )
        got = runs_arr[ro[i] : ro[i + 1]]
        assert len(got) == len(exp_runs), f"read {i}"
        for row, exp in zip(got, exp_runs):
            assert tuple(row) == exp, f"read {i}"
        if exp_v is not None:
            exp_verbose += exp_v
    assert vbytes == exp_verbose


# ---- after tests/test_native_sketch.py ----

@pytest.mark.parametrize("k,w", [(32, 100), (15, 5), (20, 10), (24, 250),
                                 (33, 10), (41, 7), (2, 1)])
def test_sketch_matches_numpy(k, w):
    sm = sketch_module()
    assert sm is not None
    rng = np.random.default_rng(k * 1000 + w)
    for n in (0, k - 1, k, k + w, 500, 4097):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        if n > 20:  # sprinkle Ns: windows must span the gaps
            codes[rng.integers(0, n, max(1, n // 40))] = 4
        ref = nt.sketch_codes(codes, k, w)
        cnt, hb, pb, fb = sm.sketch(np.ascontiguousarray(codes), k, w)
        assert cnt == len(ref)
        assert np.array_equal(np.frombuffer(hb, np.uint64), ref.hashes)
        assert np.array_equal(np.frombuffer(pb, np.int64), ref.positions)
        assert np.array_equal(np.frombuffer(fb, np.uint8).astype(bool),
                              ref.forward)


def test_all_n_sequence():
    cnt, hb, pb, fb = sketch_module().sketch(np.full(300, 4, np.uint8), 32,
                                             100)
    assert cnt == 0 and len(hb) == len(pb) == len(fb) == 0


def test_fast_hash_matches_gather():
    """The log-doubling NumPy hasher == the O(n*k) gather reference."""
    rng = np.random.default_rng(3)
    for k in (2, 8, 20, 24, 31, 32, 33, 41, 64):
        codes = rng.integers(0, 4, 700).astype(np.uint8)
        codes[rng.integers(0, 700, 12)] = 4
        a = nt.hash_kmers(codes, k)
        b = nt.hash_kmers_gather(codes, k)
        assert np.array_equal(a.out_hash, b.out_hash)
        assert np.array_equal(a.canonical, b.canonical)
        assert np.array_equal(a.forward, b.forward)
        assert np.array_equal(a.valid, b.valid)


def test_sketch_join_matches_lookup_many():
    """sketch_join == sketch + ContigIndex.lookup_many, payload for
    payload."""
    from ntlink_tpu_torch.index import ContigIndex

    rng = np.random.default_rng(11)
    k, w = 32, 100
    contig = "".join("ACGT"[c] for c in rng.integers(0, 4, 50_000))
    index = ContigIndex.from_sketches(
        [("c1", nt.sketch_sequence(contig, k, w))])
    codes = nt.encode(contig[10_000:25_000])
    res = sketch_module().sketch_join(
        codes, k, w,
        np.ascontiguousarray(index.hashes),
        np.ascontiguousarray(index.contig_ids, dtype=np.int32),
        np.ascontiguousarray(index.positions, dtype=np.int32),
        np.ascontiguousarray(index.strands.astype(np.uint8)),
    )
    assert res is not None
    n, rpos_b, cid_b, cpos_b, sbits_b, hi_b, lo_b = res
    mins = nt.sketch_codes(codes, k, w)
    found, cid, cpos, cstrand = index.lookup_many(mins.hashes)
    assert n == int(found.sum()) > 0
    assert np.array_equal(np.frombuffer(rpos_b, np.int32),
                          mins.positions[found].astype(np.int32))
    assert np.array_equal(np.frombuffer(cid_b, np.int32), cid[found])
    assert np.array_equal(np.frombuffer(cpos_b, np.int32), cpos[found])
    sbits = cstrand[found].astype(np.int32) | (
        mins.forward[found].astype(np.int32) << 1)
    assert np.array_equal(np.frombuffer(sbits_b, np.int32), sbits)
    hashes = mins.hashes[found]
    assert np.array_equal(np.frombuffer(hi_b, np.int32).view(np.uint32),
                          (hashes >> np.uint64(32)).astype(np.uint32))
    assert np.array_equal(np.frombuffer(lo_b, np.int32).view(np.uint32),
                          (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def test_host_mapper_matches_device_semantics():
    """HostMapper's raw payloads (anchor count, read positions, contig ids
    and positions, strand bits, hash halves) == TorchMapper's on the CPU
    device: from the device path and from its exact host path
    (`_host_map_raw`), reads with interior N included."""
    from ntlink_tpu_torch.device_map import TorchMapper
    from ntlink_tpu_torch.host_map import HostMapper
    from ntlink_tpu_torch.index import ContigIndex

    rng = np.random.default_rng(5)
    k, w = 32, 100
    contig = "".join("ACGT"[c] for c in rng.integers(0, 4, 40_000))
    index = ContigIndex.from_sketches(
        [("c1", nt.sketch_sequence(contig, k, w))])
    reads = []
    for i in range(8):
        s = int(rng.integers(0, 20_000))
        codes = nt.encode(contig[s : s + 12_000])
        if i % 2:  # interior Ns: windows must span gaps identically
            codes = codes.copy()
            codes[rng.integers(0, len(codes), 40)] = 4
        reads.append((f"r{i}", codes))
    hm = HostMapper(index, k, w, threads=2)
    # with_hashes: the device payload carries the hash halves too
    tm = TorchMapper(index, k, w, device="cpu", with_hashes=True)
    host = {n: raw for n, _, raw in hm.map_stream_raw(iter(reads))}
    dev = {n: raw for n, _, raw in tm.map_stream_raw(iter(reads))}
    assert tm.device_reads == len(reads) and tm.host_fallbacks == 0
    for name, codes in reads:
        for want in (dev[name], tm._host_map_raw(codes)):
            got = host[name]
            assert (want is None) == (got is None)
            if want is None:
                continue
            assert got[0] == want[0] > 0
            for a, b in zip(got[1:], want[1:]):
                assert np.array_equal(np.asarray(a), np.asarray(b)), name


# ---- after tests/test_native_io.py (golden-free) ----

def python_records(path):
    fh = open_text_maybe_gzip(path)
    try:
        return [(r.name, r.seq, r.comment, r.qual) for r in _parse(fh)]
    finally:
        fh.close()


@pytest.fixture(scope="module")
def fastx_files(tmp_path_factory):
    """The synthetic draft and its reads as FASTA, as gzipped FASTQ (with
    comments) and as gzipped FASTA wrapped at 60 columns."""
    d = tmp_path_factory.mktemp("fastx")
    write_dataset(d, seed=97, n_reads=60)
    recs = [(r.name, r.seq) for r in stream_fastx(str(d / "reads.fa"))]
    with gzip.open(d / "reads.fq.gz", "wt") as fh:
        for i, (name, seq) in enumerate(recs):
            qual = "".join(chr(33 + (j * 7 + i) % 40) for j in range(len(seq)))
            fh.write(f"@{name} read={i} len={len(seq)}\n{seq}\n+\n{qual}\n")
    with gzip.open(d / "reads_wrapped.fa.gz", "wt") as fh:
        for name, seq in recs:
            body = "\n".join(seq[i : i + 60] for i in range(0, len(seq), 60))
            fh.write(f">{name} wrapped\n{body}\n")
    return d


@pytest.mark.parametrize("fname", ["target.fa", "reads.fa", "reads.fq.gz",
                                   "reads_wrapped.fa.gz"])
def test_native_reader_matches_python(fastx_files, fname):
    path = str(fastx_files / fname)
    native = [(r.name, r.seq, r.comment, r.qual) for r in stream_fastx(path)]
    assert native == python_records(path)
    assert len(native) > 3
    assert native == [(r.name, r.seq, r.comment, r.qual)
                      for r in ref_stream_fastx(path)]


@pytest.mark.parametrize("fname", ["reads.fa", "reads.fq.gz"])
def test_stream_codes_matches_encode(fastx_files, fname):
    path = str(fastx_files / fname)
    ref = [(r.name, nt.encode(r.seq)) for r in stream_fastx(path)]
    got = list(stream_codes(path))
    assert len(got) == len(ref)
    for (gn, gc), (rn, rc) in zip(got, ref):
        assert gn == rn
        assert np.array_equal(gc, rc)


def test_weird_records(tmp_path):
    # multi-line fasta, empty seq, fastq with multi-line quality
    p = tmp_path / "x.fq"
    p.write_text(
        ">a comment here\nACGT\nACGT\n"
        ">empty\n"
        "@q1\nACGTNacgt\n+\nIIIII\nIIII\n"
        "@q2 trailing\nACGT\n+ignored\nIIII\n"
    )
    native = [(r.name, r.seq, r.comment, r.qual) for r in stream_fastx(str(p))]
    assert native == python_records(str(p))
    assert [r[0] for r in native] == ["a", "empty", "q1", "q2"]


def test_prefetch_files_order_and_parity(tmp_path):
    """The parallel multi-file prefetch yields files in input order with
    the same records as serial reads."""
    paths = []
    for i in range(5):
        p = str(tmp_path / f"r{i}.fa.gz")
        with gzip.open(p, "wt") as fh:
            for j in range(50):
                fh.write(f">f{i}_r{j}\n{'ACGT' * (10 + j)}\n")
        paths.append(p)
    serial = [(p, [(r.name, r.seq) for r in stream_fastx(p)]) for p in paths]
    for threads in (1, 3, 8):
        got = [
            (p, [(r.name, r.seq) for r in it])
            for p, it in prefetch_files(paths, stream_fastx, threads=threads)
        ]
        assert got == serial, f"threads={threads}"


def test_prefetch_files_propagates_exceptions(tmp_path):
    ok = str(tmp_path / "ok.fa")
    with open(ok, "w") as fh:
        fh.write(">a\nACGT\n")
    results = prefetch_files([ok, str(tmp_path / "missing.fa")],
                             stream_fastx, threads=2)
    p, it = next(results)
    assert [r.name for r in it] == ["a"]
    p, it = next(results)
    with pytest.raises(OSError):
        list(it)


@pytest.mark.parametrize("with_strand", [True, False])
def test_native_minimizer_render_matches_python(with_strand):
    """The C TSV body renderer == the Python formatter, byte for byte,
    64-bit boundary hashes and empty input included."""
    from ntlink_tpu_torch.sketch import (
        format_minimizers, format_minimizers_bytes,
    )

    rng = np.random.default_rng(9)
    hashes = np.concatenate([
        rng.integers(0, 2**63, 500, dtype=np.uint64) * np.uint64(2),
        np.array([0, 1, 2**63, 2**64 - 1, 10**19], dtype=np.uint64),
    ])
    n = len(hashes)
    mins = nt.Minimizers(hashes,
                         np.sort(rng.integers(0, 2**31, n)).astype(np.int64),
                         rng.integers(0, 2, n).astype(bool))
    got = format_minimizers_bytes(mins, with_strand=with_strand)
    assert got == format_minimizers(mins, with_strand=with_strand).encode()
    empty = nt.Minimizers(np.zeros(0, np.uint64), np.zeros(0, np.int64),
                          np.zeros(0, bool))
    assert format_minimizers_bytes(empty, with_strand=with_strand) == b""


def test_prefetch_files_abandonment_releases_workers(tmp_path):
    """A consumer that stops mid-stream (an error elsewhere) leaves no
    blocked worker behind (the rounds flow loops in one process)."""
    paths = []
    for i in range(3):
        p = tmp_path / f"r{i}.fa"
        with open(p, "w") as fh:
            for j in range(500):
                fh.write(f">s{j}\nACGTACGTAC\n")
        paths.append(str(p))
    n_before = threading.active_count()
    gen = prefetch_files(paths, stream_fastx, threads=3, depth=4)
    path, it = next(gen)
    next(it)  # consume one record, then abandon everything
    gen.close()
    deadline = time.time() + 10
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before, "prefetch workers leaked"
