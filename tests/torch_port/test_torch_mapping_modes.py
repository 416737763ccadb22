"""Chaining modes of the port (subsume marking, the z filter, the noisy-span
filter and its x fudge factor), after ``tests/test_mapping_modes.py``:
the six hand-built reads through the port's `mapping.chain_read_hits`,
with that test's expectations. The reads with the default knobs
(sensitive=False, x=0) also go through the device chaining
(`chain.chain_anchors_device` + `summarize_runs_device`, on the CPU), whose
run rows must be the host's, and through ``ntlink_tpu.mapping``, whose runs
must be the port's. Exact comparison everywhere."""
import pytest
import torch

from ntlink_tpu import mapping as ref_mapping
from ntlink_tpu_torch.chain import chain_anchors_device, summarize_runs_device
from ntlink_tpu_torch.mapping import AnchorHit, chain_read_hits

K = 32
LENGTHS = {"A": 5000, "B": 5000, "C": 5000, "S": 100}
NAMES = sorted(LENGTHS)


def mk_hits(pattern, hit=AnchorHit):
    """pattern: list of (contig, ctg_pos); read positions increase by 100."""
    return [
        (ctg, hit(1000 + i, pos, "+", i * 100, "+"))
        for i, (ctg, pos) in enumerate(pattern)
    ]


def contigs_of(runs):
    return [r.contig for r in runs]


CASCADE = [("A", 10), ("B", 10), ("A", 120), ("C", 10), ("B", 130)]


def test_specific_mode_cascading_subsume():
    # run order A B A C B: A-repeat subsumes B; B-repeat subsumes A and C
    runs = chain_read_hits(mk_hits(CASCADE), 1000, LENGTHS, k=K, z=100,
                           sensitive=False)
    assert runs == []


def test_sensitive_mode_run_level_subsume():
    runs = chain_read_hits(mk_hits(CASCADE), 1000, LENGTHS, k=K, z=100,
                           sensitive=True)
    assert contigs_of(runs) == ["A", "B"]
    # surviving runs: first A run and last B run only
    assert runs[0].hit_count == 1 and runs[1].hit_count == 1


def test_simple_nested_contig_subsumed_and_merged():
    # A B A -> B subsumed, A runs merged
    hits = mk_hits([("A", 10), ("B", 10), ("A", 120)])
    runs = chain_read_hits(hits, 1000, LENGTHS, k=K, z=100)
    assert contigs_of(runs) == ["A"]
    assert runs[0].hit_count == 2


def test_z_filter_drops_short_contigs():
    hits = mk_hits([("A", 10), ("S", 10), ("B", 10)])
    runs = chain_read_hits(hits, 1000, LENGTHS, k=K, z=1000)
    assert contigs_of(runs) == ["A", "B"]


def test_noisy_span_filter():
    # contig span 4000 > read_len + k -> contig dropped entirely
    hits = mk_hits([("A", 10), ("A", 4010), ("B", 50)])
    runs = chain_read_hits(hits, read_length=3000, contig_lengths=LENGTHS,
                           k=K, z=100)
    assert contigs_of(runs) == ["B"]
    # with a long enough read it survives
    runs = chain_read_hits(hits, read_length=4500, contig_lengths=LENGTHS,
                           k=K, z=100)
    assert contigs_of(runs) == ["A", "B"]


def test_noisy_fudge_factor():
    # x=1: threshold = min(read_len+k, read-span+k); ctg span 2000 over
    # read span 100 -> dropped
    hits = mk_hits([("A", 10), ("A", 2010)])
    assert chain_read_hits(hits, 3000, LENGTHS, k=K, z=100, x=1.0) == []
    runs = chain_read_hits(hits, 3000, LENGTHS, k=K, z=100, x=0.0)
    assert contigs_of(runs) == ["A"]


#: the reads above that run with the default knobs: (pattern, read length,
#: z, contigs of the accepted runs)
DEFAULT_KNOBS = {
    "cascading-subsume": (CASCADE, 1000, 100, []),
    "nested-merged": ([("A", 10), ("B", 10), ("A", 120)], 1000, 100, ["A"]),
    "z-filter": ([("A", 10), ("S", 10), ("B", 10)], 1000, 1000, ["A", "B"]),
    "noisy-short-read": ([("A", 10), ("A", 4010), ("B", 50)], 3000, 100,
                         ["B"]),
    "noisy-long-read": ([("A", 10), ("A", 4010), ("B", 50)], 4500, 100,
                        ["A", "B"]),
    "fudge-x0": ([("A", 10), ("A", 2010)], 3000, 100, ["A"]),
}


def _run_row(run):
    f, t = run.first_hit, run.terminal_hit
    return (run.contig, run.hit_count, f.ctg_pos, f.read_pos, t.ctg_pos,
            t.read_pos)


@pytest.mark.parametrize("case", sorted(DEFAULT_KNOBS))
def test_default_knobs_chain_alike_on_the_device(case):
    pattern, read_len, z, want = DEFAULT_KNOBS[case]
    host = chain_read_hits(mk_hits(pattern), read_len, LENGTHS, k=K, z=z)
    assert contigs_of(host) == want
    jax_runs = ref_mapping.chain_read_hits(
        mk_hits(pattern, ref_mapping.AnchorHit), read_len, LENGTHS, k=K, z=z)
    assert [_run_row(r) for r in jax_runs] == [_run_row(r) for r in host]

    n = len(pattern)
    cid = torch.tensor([[NAMES.index(c) for c, _ in pattern]],
                       dtype=torch.int32)
    cpos = torch.tensor([[p for _, p in pattern]], dtype=torch.int32)
    # rpos | ctg strand "+" << 29 | read strand "+" << 30
    rposw = torch.tensor([[i * 100 | 3 << 29 for i in range(n)]],
                         dtype=torch.int32)
    clen = torch.tensor([LENGTHS[c] for c in NAMES], dtype=torch.int32)
    keep, overflow = chain_anchors_device(
        torch.ones((1, n), dtype=torch.bool), cid, cpos,
        torch.tensor([read_len], dtype=torch.int32), clen, z, K)
    assert not overflow.any()
    valid, r_cid, cnt, f_cpos, l_cpos, f_rw, l_rw = (
        a[0].tolist() for a in summarize_runs_device(keep, cid, cpos, rposw))
    nv = sum(valid)
    got = [(NAMES[r_cid[i]], cnt[i], f_cpos[i], f_rw[i] & 0x1FFFFFFF,
            l_cpos[i], l_rw[i] & 0x1FFFFFFF) for i in range(nv)]
    assert got == [_run_row(r) for r in host]
    assert all((f_rw[i] >> 29) & 3 == 3 for i in range(nv))
