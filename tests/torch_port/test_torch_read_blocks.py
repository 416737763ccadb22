"""The reader's blocks of reads (``seqio.fastx.stream_code_blocks``, the C
reader's ``Reader.read_block``) against its records one at a time
(`stream_codes`): the same names, codes and non-ACGT flags, record for
record, across FASTA and FASTQ, gzip, multi-line records, N runs, empty
and sub-k records and quality that ends early, at blocks of 1, 2 and 3
records, of a few bases and of the mapper's size, from the C reader and
from the pure-Python fallback. Every comparison is exact."""
import gzip

import numpy as np
import pytest

from ntlink_tpu_torch import native
from ntlink_tpu_torch.device_map import TorchMapper
from ntlink_tpu_torch.seqio.fastx import stream_code_blocks, stream_codes

BASES = np.array(list("ACGT"))


def _seq(rng, n, n_run=0):
    seq = "".join(BASES[rng.integers(0, 4, n)])
    if n_run:
        at = n // 3
        seq = seq[:at] + "N" * n_run + seq[at + n_run:]
    return seq


def _records(rng):
    """(name, sequence): long and short, an N run, a lower-case stretch
    with an IUPAC code, an empty record and sub-k ones."""
    return [
        ("long", _seq(rng, 12_000)),
        ("n_run", _seq(rng, 3_000, n_run=150)),
        ("empty", ""),
        ("sub_k", "ACGTACG"),
        ("lower", _seq(rng, 500).lower()[:250] + "R" + _seq(rng, 249)),
        ("one", "T"),
        ("mid", _seq(rng, 1_500)),
    ]


def _fasta(records, wrap):
    out = []
    for i, (name, seq) in enumerate(records):
        out.append(f">{name} comment {i}\n" if i % 2 else f">{name}\n")
        if wrap:
            out += [seq[a : a + wrap] + "\n" for a in range(0, len(seq), wrap)]
        elif seq:
            out.append(seq + "\n")
    return "".join(out)


def _fastq(records, wrap, cut_last_qual=False):
    out = []
    for i, (name, seq) in enumerate(records):
        qual = "I" * len(seq)
        if cut_last_qual and i == len(records) - 1:
            qual = qual[: len(qual) // 2]   # the file ends mid-quality
        out.append(f"@{name}\n")
        step = wrap or max(1, len(seq))
        out += [seq[a : a + step] + "\n" for a in range(0, len(seq), step)]
        out.append("+\n")
        out += [qual[a : a + step] + "\n" for a in range(0, len(qual), step)]
        if not qual:
            out.append("\n")
    text = "".join(out)
    return text[:-1] if cut_last_qual else text


FILES = {
    "fasta": lambda r: _fasta(r, 0),
    "fasta_multiline_gz": lambda r: _fasta(r, 70),
    "fastq": lambda r: _fastq(r, 0),
    "fastq_multiline_gz": lambda r: _fastq(r, 60),
    "fastq_quality_ends_early": lambda r: _fastq(r, 0, cut_last_qual=True),
}
#: (records a block, bases a block): 1, 2 and 3 records; blocks cut by a
#: few bases; the mapper's blocks
SIZES = {"1 read": (1, 1 << 40), "2 reads": (2, 1 << 40),
         "3 reads": (3, 1 << 40), "100 bases": (0, 100),
         "default": (0, TorchMapper.BLOCK_BASES)}


@pytest.mark.parametrize("reader", ["native", "python"])
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("kind", list(FILES))
def test_blocks_hold_the_records_of_stream_codes(kind, size, reader,
                                                 tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    records = _records(rng)
    text = FILES[kind](records)
    path = str(tmp_path / ("reads.gz" if kind.endswith("_gz") else "reads"))
    with (gzip.open if kind.endswith("_gz") else open)(path, "wt") as fh:
        fh.write(text)
    assert native.fastx_module() is not None
    want = [(name, codes.copy()) for name, codes in stream_codes(path)]
    assert [name for name, _ in want] == [name for name, _ in records]
    if reader == "python":
        monkeypatch.setitem(native._modules, "ntlink_fastx", None)
    block_reads, block_bases = SIZES[size]
    blocks = list(stream_code_blocks(path, block_bases, block_reads))
    got = []
    for b, block in enumerate(blocks):
        n = len(block)
        assert n == len(block.names) == len(block.has_n) == \
            len(block.offsets) - 1 > 0
        assert block.codes.dtype == np.uint8
        assert block.offsets.dtype == np.int64 and block.offsets[0] == 0
        assert block.offsets[-1] == len(block.codes)
        assert block.has_n.dtype == np.bool_
        # each block but the last ends at the record that brings it to
        # its bases or its records, and no earlier
        bases = np.diff(block.offsets)
        full = (np.cumsum(bases) >= block_bases) | (
            np.arange(1, n + 1) == block_reads)
        assert not full[:-1].any()
        assert full[-1] or b == len(blocks) - 1
        for name, row, has_n in zip(block.names, block.rows(),
                                    block.has_n.tolist()):
            assert has_n == bool((row > 3).any())
            got.append((name, row))
    assert [name for name, _ in got] == [name for name, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert np.array_equal(a, b), name
