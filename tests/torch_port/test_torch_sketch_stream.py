"""TorchSketcher.sketch_stream (the port's contig sketch) against
ntlink_tpu's JaxSketcher (JAX on the CPU) and the native C sketcher,
sequence by sequence. MAX_PAD shrinks to 4096 on the instances so that
chunking triggers at test scale (as tests/test_sketch_jax.py does); the
rows include chunk seams that tie (all-A, period 2), N rows on the device,
oversized N rows and sub-k rows on the host, and with a shrunk slot budget
slot-overflow rows. Every value is an integer: exact."""
import numpy as np
import pytest

from ntlink_tpu.ops.sketch_jax import JaxSketcher
from ntlink_tpu.sketch import sketch_sequences
from ntlink_tpu_torch.sketch import TorchSketcher

MAX_PAD = 4096


def _rows(seed, k, w):
    rng = np.random.default_rng(seed)
    seam = MAX_PAD - (k + w - 2)  # first window of the second chunk

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    def with_n(n, spans):
        c = rand(n)
        for st, ln in spans:
            c[st : st + ln] = 4
        return c

    def tie_at_seam(fill):
        # random, but all keys tie across the first chunk seam
        c = rand(2 * MAX_PAD + 300)
        c[seam - 150 : seam + 150] = np.resize(np.array(fill, np.uint8), 300)
        return c

    rows = [
        rand(3000),
        rand(MAX_PAD),
        rand(MAX_PAD + 1),                       # two chunks, the last short
        rand(3 * MAX_PAD + 777),                 # four chunks
        tie_at_seam((0,)),                       # all-A at the seam
        tie_at_seam((2, 1)),                     # period 2 at the seam
        # every key ties: each chunk overflows its slots, host path
        np.zeros(2 * MAX_PAD + 300, np.uint8),
        np.resize(np.array([2, 1], np.uint8), 2 * MAX_PAD + 51),
        rand(20),                                # sub-k
        with_n(3500, [(1000, 1), (2000, 150)]),
        with_n(1500, [(0, 40), (1460, 40)]),
        with_n(MAX_PAD, [(100, 3900)]),          # valid stretches < w
        with_n(2 * MAX_PAD + 10, [(5000, 30)]),  # oversized with N: host
        np.full(1200, 4, np.uint8),              # all N
    ]
    rows += [rand(int(n)) for n in rng.integers(200, 3 * MAX_PAD, 12)]
    return [(f"s{i}", c) for i, c in enumerate(rows)]


def _shrunk(sk, slots):
    sk.MAX_PAD = MAX_PAD
    if slots:
        sk.MAX_SLOTS = slots
    return sk


@pytest.mark.parametrize("k,w,slots", [(32, 100, 0), (15, 5, 512)])
def test_sketch_stream_matches_jax_and_native(k, w, slots):
    rows = _rows(k + w, k, w)
    ts = _shrunk(TorchSketcher("cpu", batch_bases=8 * MAX_PAD), slots)
    got = list(ts.sketch_stream(iter(rows), k, w))
    js = _shrunk(JaxSketcher(batch_bases=8 * MAX_PAD), slots)
    want_jax = list(js.sketch_stream(iter(rows), k, w))
    want_c = list(sketch_sequences(iter(rows), k, w, backend=None))
    for want in (want_jax, want_c):
        assert len(want) == len(got)
        for (n, ln, m), (n2, ln2, m2) in zip(got, want):
            assert (n, ln) == (n2, ln2)
            assert np.array_equal(m.positions, m2.positions), n
            assert np.array_equal(m.hashes, m2.hashes), n
            assert np.array_equal(m.forward, m2.forward), n
    assert ts.chunked == sum(
        len(c) > MAX_PAD and not (c > 3).any() for _, c in rows
    )
    assert any(has_n for _, has_n in ts.batches_by_pad)
    # the sub-k row and the oversized N row, then slot-overflow rows (the
    # all-tie rows' chunks; the longer random rows at w=5 with 512 slots)
    assert ts.host_fallbacks > 2
    assert ts.device_rows > 5


def test_sketch_stream_preserves_order_across_flushes():
    """A batch budget of one row per pad forces flushes mid-stream; the
    stream still yields in input order, chunked rows included."""
    rows = _rows(3, 32, 100)
    ts = _shrunk(TorchSketcher("cpu", batch_bases=MAX_PAD), 0)
    names = [n for n, _, _ in ts.sketch_stream(iter(rows), 32, 100)]
    assert names == [n for n, _ in rows]
