"""N rows through the port's own sketch path, after
``tests/test_sketch_n.py``: rows with N runs (single, long, at either end,
many, all N, valid stretches shorter than w, a short row) are packed as the
streams pack them (`stream_pipeline.pack_batch`: cleaned to A, a bit mask of
the N), sketched (`mapping_step.sketch_batch`: the kernel's plain version
on the CPU, then `ops.sketch_torch.compact_windows`) and finished
(`finish_hash`); the minimizers equal ``ntlink_tpu``'s `nthash_np` and the
windows equal the JAX kernel's (`sketch_batch_kernel(...,
compact_invalid=True)`). `sketch.TorchSketcher` gives the same sketches
through its (pad, has N) buckets, at k=32 w=100 and at the overlap and
gap-fill shapes (15/5, 20/10). Exact comparison everywhere."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntlink_tpu.ops import nthash_np
from ntlink_tpu.ops.sketch_jax import sketch_batch_kernel
from ntlink_tpu_torch.mapping_step import sketch_batch
from ntlink_tpu_torch.ops.sketch_torch import finish_hash
from ntlink_tpu_torch.sketch import TorchSketcher
from ntlink_tpu_torch.stream_pipeline import pack_batch

K, W = 32, 100


def _rand_codes(rng, n):
    return rng.integers(0, 4, n, dtype=np.uint8)


def _plant(rng, n, spans):
    c = _rand_codes(rng, n)
    for start, ln in spans:
        c[start : start + ln] = 4
    return c


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(21)
    L = 4096
    return [
        _rand_codes(rng, L),                        # clean
        _plant(rng, L, [(2000, 1)]),                # single N mid-row
        _plant(rng, L, [(1000, 500)]),              # long gap run
        _plant(rng, L, [(0, 40)]),                  # N at row start
        _plant(rng, L, [(L - 40, 40)]),             # N at row end
        _plant(rng, L, [(300, 5), (400, 5), (500, 5), (900, 200)]),  # many
        _plant(rng, L, [(0, L)]),                   # all N
        _plant(rng, L, [(100, 3900)]),              # valid stretches < w
        _plant(rng, 2500, [(1200, 60)]),            # short row w/ gap
    ]


def _port_windows(rows, k, w):
    """The port's sketch of `rows` as one N batch: the (can, fwd, winner,
    emit) tensors, and the pad."""
    pad = -(-max(len(c) for c in rows) // 8) * 8
    packed, nmask = pack_batch(list(rows), len(rows), pad, True)
    lengths = np.array([len(c) for c in rows], np.int32)
    out = sketch_batch(torch.from_numpy(packed.copy()),
                       torch.from_numpy(lengths),
                       k, w, pad, torch.from_numpy(nmask))
    return out, pad


def _check_rows(rows, k, w):
    (can, fwd, winner, emit), pad = _port_windows(rows, k, w)
    codes = np.full((len(rows), pad), 4, np.uint8)
    for i, c in enumerate(rows):
        codes[i, : len(c)] = c
    lengths = np.array([len(c) for c in rows], np.int32)
    *_, j_win, j_emit = sketch_batch_kernel(
        jnp.asarray(codes), jnp.asarray(lengths), k, w, compact_invalid=True)
    j_win, j_emit = np.asarray(j_win), np.asarray(j_emit)
    assert np.array_equal(emit.numpy(), j_emit)
    for r, c in enumerate(rows):
        ref = nthash_np.sketch_codes(c, k, w)
        e = emit[r]
        sel = winner[r][e].long()
        assert np.array_equal(sel.numpy(), j_win[r][j_emit[r]]), r
        assert np.array_equal(sel.numpy(), ref.positions), f"row {r} positions"
        got = finish_hash(can[r][sel], k).numpy().view(np.uint64)
        assert np.array_equal(got, ref.hashes), f"row {r} hashes"
        assert np.array_equal(fwd[r][sel].numpy(), ref.forward), f"row {r}"


def test_compacted_windows_match_numpy_and_jax(rows):
    _check_rows(rows, K, W)


def test_sketch_stream_n_rows_on_device(rows):
    """Through the batched sketcher: N rows give exactly the NumPy sketches
    and share batches per (pad, has_n) bucket."""
    sk = TorchSketcher("cpu", batch_bases=64 * 4096)
    named = [(f"s{i}", c) for i, c in enumerate(rows)]
    got = {n: m for n, _, m in sk.sketch_stream(iter(named), K, W)}
    for i, c in enumerate(rows):
        ref = nthash_np.sketch_codes(c, K, W)
        m = got[f"s{i}"]
        assert np.array_equal(m.positions, ref.positions), f"s{i}"
        assert np.array_equal(m.hashes, ref.hashes), f"s{i}"
        assert np.array_equal(m.forward, ref.forward), f"s{i}"
    assert sk.host_fallbacks == 0
    assert sk.batches_by_pad == {(4096, False): 1, (4096, True): 1}


def test_compacted_windows_random_property():
    """Randomized N placement across densities and (k, w) shapes."""
    rng = np.random.default_rng(99)
    for trial in range(6):
        k = int(rng.integers(12, 48))
        w = int(rng.integers(2, 160))
        L = int(rng.integers(k + w + 10, 3000))
        c = _rand_codes(rng, L)
        # random N density 0..20%
        c[rng.integers(0, L, int(L * rng.random() * 0.2))] = 4
        _check_rows([c], k, w)


@pytest.mark.parametrize("k,w", [(15, 5), (20, 10)])
def test_sketch_stream_n_rows_small_k(k, w):
    """The overlap (15/5) and gap-fill (20/10) shapes, with gaps."""
    rng = np.random.default_rng(33 + k)
    rows = [
        _plant(rng, 3000, [(500, 120), (1500, 7)]),
        _plant(rng, 3000, [(0, 100), (2900, 100)]),
    ]
    sk = TorchSketcher("cpu", batch_bases=8 * 4096)
    got = {n: m for n, _, m in sk.sketch_stream(
        iter((f"x{i}", c) for i, c in enumerate(rows)), k, w)}
    for i, c in enumerate(rows):
        ref = nthash_np.sketch_codes(c, k, w)
        m = got[f"x{i}"]
        assert np.array_equal(m.positions, ref.positions)
        assert np.array_equal(m.hashes, ref.hashes)
        assert np.array_equal(m.forward, ref.forward)
    assert sk.batches_by_pad == {(4096, True): 1}
