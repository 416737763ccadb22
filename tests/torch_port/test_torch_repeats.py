"""repeats=True through the port: the mapping step's hash planes
(`with_hashes`) against ``mesh.mapping_step_packed(with_hashes=True)``,
with and without N rows, and the `pair` artifacts against ntlink_tpu's
backend=numpy pair stage. Inputs come from numpy seeds; every comparison
is exact."""
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu.index import ContigIndex
from ntlink_tpu.ops import nthash_np
from ntlink_tpu.parallel import mesh
from ntlink_tpu.pipeline import pair_stage as jax_pair_stage
from ntlink_tpu.stream_pipeline import split_n_rows
from ntlink_tpu_torch import mapping_step as ms
from ntlink_tpu_torch import pipeline

from .synthetic import write_dataset

PREFIX = "target.fa.k32.w100.z1000"


def _batch(k, w, L, B, seed, n_rows):
    """A contig index and a (B, L) batch of reads cut from it (3%
    substitutions, both strands, one read repeated within itself so that
    its hashes occur twice); rows in `n_rows` get N runs."""
    rng = np.random.default_rng(seed)
    contigs = [rng.integers(0, 4, 60_000).astype(np.uint8) for _ in range(3)]
    index = ContigIndex.from_sketches(
        (f"c{i}", nthash_np.sketch_codes(c, k, w))
        for i, c in enumerate(contigs)
    )
    rows = []
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lengths[0] = 0
    for r in range(B):
        c = contigs[r % 3]
        st = int(rng.integers(0, len(c) - L))
        read = c[st : st + lengths[r]].copy()
        err = rng.random(len(read)) < 0.03
        read[err] = rng.integers(0, 4, err.sum())
        if r % 2:
            read = (3 - read)[::-1]
        rows.append(read)
    rows[1][len(rows[1]) // 2 :] = rows[1][: len(rows[1]) - len(rows[1]) // 2]
    for r in n_rows:
        for st in rng.integers(0, lengths[r], 4):
            rows[r][st : st + int(rng.integers(1, 200))] = 4
    return index, rows, lengths


@pytest.mark.parametrize("with_n", [False, True])
def test_mapping_step_hash_planes_match_jax(with_n):
    k, w, L, B, S = 32, 100, 4096, 8, 256
    index, rows, lengths = _batch(k, w, L, B, 31, (2, 3) if with_n else ())
    clean, nmask = split_n_rows(rows, B, L) if with_n else (rows, None)
    codes = np.zeros((B, L), np.uint8)
    for r, c in enumerate(clean):
        codes[r, : len(c)] = c
    packed = ms.pack_codes(codes)
    jidx = mesh.DeviceIndex.from_contig_index(index)
    out = mesh.mapping_step_packed(
        jnp.asarray(packed), jnp.asarray(lengths), jidx.t_bkt, k, w, L,
        jidx.mask, jidx.max_probes, S, use_pallas=False, with_hashes=True,
        nmask=None if nmask is None else jnp.asarray(nmask), t_off=None,
    )
    jf = np.asarray(out["flat"])
    v = np.asarray(out["r16"]).view(np.uint16).astype(np.int32)
    j_count, j_nmin = jf[0, :B], jf[0, B : 2 * B]
    j_planes = [v & 0x3FFF, (v >> 14) & 3, jf[1], jf[2], jf[3], jf[4]]
    tidx = ms.DeviceIndex.from_numpy(
        np.asarray(jidx.t_bkt), jidx.mask, jidx.max_probes
    )
    flat = ms.mapping_step(
        torch.from_numpy(packed), torch.from_numpy(lengths), tidx, k, w, L,
        S, nmask=None if nmask is None else torch.from_numpy(nmask),
        with_hashes=True,
    ).numpy()
    t_count, t_nmin = flat[:B], flat[B : 2 * B]
    tp = flat[2 * B :].reshape(5, B * S)
    t_planes = [tp[0] & 0x1FFFFFFF, (tp[0] >> 29) & 3, tp[1], tp[2], tp[3],
                tp[4]]
    assert np.array_equal(t_count, j_count)
    assert np.array_equal(t_nmin, j_nmin)
    n = int(t_count.sum())
    assert n > 0
    for t, j in zip(t_planes, j_planes):
        assert np.array_equal(t[:n], j[:n])
    # the repeated read carries equal hashes twice
    hashes = (tp[3, : t_count[0] + t_count[1]].astype(np.int64) << 32) | (
        tp[4, : t_count[0] + t_count[1]].astype(np.int64) & 0xFFFFFFFF)
    assert len(np.unique(hashes)) < len(hashes)
    with pytest.raises(ValueError):
        ms.mapping_step(torch.from_numpy(packed), torch.from_numpy(lengths),
                        tidx, k, w, L, S, clen=torch.zeros(3, dtype=torch.int32),
                        runs=True, with_hashes=True)


def test_pair_repeats_matches_jax_package(tmp_path, monkeypatch):
    """repeats=True: host-chained per-anchor payloads with hash planes;
    the repeat filter drops anchors whose hash occurs twice in a read. The
    DOT, pairs.tsv and verbose_mapping are ntlink_tpu's backend=numpy
    bytes."""
    for side in ("torch", "numpy"):
        write_dataset(tmp_path / side, seed=14)
        with open(tmp_path / side / "reads.fa", "a") as fh:
            # a read whose second half repeats its first
            with open(tmp_path / side / "target.fa") as tf:
                seq = tf.read().split("\n")[1][1000:9000]
            fh.write(f">tandem\n{seq}{seq}\n")
    cfg = dict(target="target.fa", reads=["reads.fa"], k=32, w=100, z=1000,
               pairs_tsv=True, repeats=True)
    monkeypatch.chdir(tmp_path / "torch")
    pipeline.pair_stage(ScaffoldConfig(batch_bases=200_000, **cfg),
                        device="cpu")
    mapper = pipeline.last_mapper
    assert mapper.with_hashes and not mapper.prechained
    assert mapper.device_reads > 0
    monkeypatch.chdir(tmp_path / "numpy")
    jax_pair_stage(ScaffoldConfig(backend="numpy", t=1, **cfg))
    for art in (".n1.scaffold.dot", ".pairs.tsv", ".verbose_mapping.tsv"):
        port = tmp_path / "torch" / (PREFIX + art)
        assert os.path.getsize(port) > 0, art
        assert filecmp.cmp(port, tmp_path / "numpy" / (PREFIX + art),
                           shallow=False), art
