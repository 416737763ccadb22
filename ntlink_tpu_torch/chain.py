"""Chaining acceptance and per-run summaries over (B, S) anchor planes.

Counterpart of ``ntlink_tpu/parallel/mesh.py`` `chain_anchors_device`
(:388-502) and `summarize_runs_device` (:505-567): the z filter, the
noisy-span filter, consecutive-run grouping, specific-mode subsume and the
keep mask, then the merged runs the pair tally reads (reference
ntlink_utils.py:200-294; exact semantics of ``native/chain.c``). Masked
tensor ops only, so every shape depends on the batch alone.

Two TPU workarounds of the JAX functions are gone, with identical results:
the one-hot noisy-span form (`NOISY_ONEHOT_MAX`) is one `scatter_reduce`
table for every contig count, and the `top_k` lane extraction is a cumsum +
scatter. The previous/next kept anchor is found by a cummax/cummin over lane
indices rather than over an int32 `(lane << 13) | cid` key, so no bound on
the lane count exists (the JAX key overflows past 2^18 lanes).
"""
from __future__ import annotations

import torch

#: run lanes per read; a read with more runs is chained on the exact host
#: path (mesh.RUN_LANES)
RUN_LANES = 64
#: contig-count gate for on-device chaining (mesh.CHAIN_MAX_CONTIGS): kept
#: so that `prechained` and the payload kind match DeviceMapper's
CHAIN_MAX_CONTIGS = 4096

_I32_MAX = 0x7FFFFFFF


def _prev_kept(keep: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """For each lane, `vals` at the nearest kept lane strictly before it;
    -1 where there is none."""
    B, S = keep.shape
    lane = torch.arange(S, device=keep.device).expand(B, S)
    last = torch.where(keep, lane, -1).cummax(dim=1).values
    prev = torch.cat([torch.full((B, 1), -1, device=keep.device,
                                 dtype=last.dtype), last[:, :-1]], dim=1)
    return torch.where(prev >= 0, vals.gather(1, prev.clamp(min=0)), -1)


def _next_kept(keep: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """For each lane, `vals` at the nearest kept lane strictly after it;
    -1 where there is none."""
    B, S = keep.shape
    lane = torch.arange(S, device=keep.device).expand(B, S)
    first = torch.where(keep, lane, S).flip(1).cummin(dim=1).values.flip(1)
    nxt = torch.cat([first[:, 1:], torch.full((B, 1), S, device=keep.device,
                                              dtype=first.dtype)], dim=1)
    return torch.where(nxt < S, vals.gather(1, nxt.clamp(max=S - 1)), -1)


def _mask_lanes(mask: torch.Tensor, n: int):
    """Lane indices of the first `n` set bits per row, in order (cumsum +
    scatter): (lanes (B, n) int64, 0 past the last set bit; valid (B, n))."""
    B, S = mask.shape
    rank = mask.to(torch.int64).cumsum(dim=1) - 1
    tgt = torch.where(mask & (rank < n), rank, n)
    lanes = torch.zeros((B, n + 1), dtype=torch.int64, device=mask.device)
    lanes.scatter_(1, tgt, torch.arange(S, device=mask.device).expand(B, S))
    valid = (
        torch.arange(n, device=mask.device)[None, :] < mask.sum(dim=1)[:, None]
    )
    return lanes[:, :n], valid


def chain_anchors_device(found, cid, cpos, rlens, clen, z: int, k: int):
    """Chaining acceptance over (B, S) anchor planes (found bool, cid and
    cpos int32), read lengths `rlens` (B,) and contig lengths `clen` (NC,).
    Valid for the default knobs (x == 0, sensitive=False, no repeat
    filter). Returns (keep (B, S) bool, overflow (B,) bool): `keep` marks
    the anchors of accepted runs, and `overflow` the rows with more than
    RUN_LANES runs, whose `keep` is wiped for the exact host path."""
    B, S = found.shape
    dev = found.device
    NC = int(clen.shape[0])
    R = RUN_LANES

    # 1. z filter (cid is in range wherever found)
    cidc = cid.to(torch.int64).clamp(0, NC - 1)
    kept0 = found & (clen.to(torch.int64)[cidc] >= z)

    # 2. noisy-span filter: per (read, contig) min/max contig position and
    # anchor count in (B, NC + 1) tables (last column = dump); a contig with
    # >= 2 anchors whose span outruns read_len + k drops entirely
    tcid = torch.where(kept0, cidc, NC)
    cp = cpos.to(torch.int64)
    amin = torch.full((B, NC + 1), _I32_MAX, dtype=torch.int64, device=dev)
    amin.scatter_reduce_(1, tcid, cp, "amin")
    amax = torch.full((B, NC + 1), -1, dtype=torch.int64, device=dev)
    amax.scatter_reduce_(1, tcid, cp, "amax")
    acnt = torch.zeros((B, NC + 1), dtype=torch.int64, device=dev)
    acnt.scatter_add_(1, tcid, torch.ones_like(tcid))
    noisy = (acnt >= 2) & (
        (amax - amin) > (rlens.to(torch.int64) + k)[:, None]
    )
    kept1 = kept0 & ~noisy.gather(1, tcid)

    # 3. consecutive runs over kept anchors: a kept anchor starts a run iff
    # the previous kept anchor's cid differs
    runstart = kept1 & (_prev_kept(kept1, cidc) != cidc)
    run_id = runstart.to(torch.int64).cumsum(dim=1) - 1
    overflow = run_id[:, -1] + 1 > R
    rid = torch.where(kept1, run_id.clamp(max=R - 1), R)
    rs_lanes, rvalid = _mask_lanes(runstart, R)
    run_cid = torch.where(rvalid, cidc.gather(1, rs_lanes), -1)

    # 4. specific-mode subsume: every contig sighted strictly between the
    # first occurrence of a contig c and a later occurrence of c is doomed
    # (all of its runs drop); between[q] = exists i < q with is_first[i] and
    # last_occ[i] > q, one exclusive prefix-max over O(R^2) reductions
    r = torch.arange(R, device=dev)
    same = (
        rvalid[:, :, None]
        & rvalid[:, None, :]
        & (run_cid[:, :, None] == run_cid[:, None, :])
    )
    has_earlier = (same & (r[None, :, None] > r[None, None, :])).any(dim=2)
    is_first = rvalid & ~has_earlier
    last_occ = torch.where(same, r[None, None, :], -1).amax(dim=2)
    f = torch.where(is_first, last_occ, -1)
    pmax = f.cummax(dim=1).values
    pmax_excl = torch.cat(
        [torch.full((B, 1), -1, dtype=f.dtype, device=dev), pmax[:, :-1]],
        dim=1,
    )
    between = rvalid & (pmax_excl > r[None, :])
    doomed = (same & between[:, None, :]).any(dim=2)
    keep_run = rvalid & ~doomed

    # 5. an anchor survives iff its run does; overflow rows are wiped
    keep_run = torch.cat(
        [keep_run, torch.zeros((B, 1), dtype=torch.bool, device=dev)], dim=1
    )
    keep = kept1 & keep_run.gather(1, rid)
    return keep & ~overflow[:, None], overflow


def summarize_runs_device(keep, cid, cpos, rposw):
    """Per-read merged runs of the accepted anchors: consecutive kept
    anchors with the same cid form one run (chain.c's prechained grouping).
    Returns (valid (B, RUN_LANES) bool in read order, run_cid, count,
    f_cpos, l_cpos, f_rposw, l_rposw, all (B, RUN_LANES) int32). Rows with
    more than RUN_LANES runs must already be wiped from `keep`
    (chain_anchors_device's overflow). Lanes past a row's last run hold
    lane 0's fields, as in the JAX function."""
    ccid = cid.to(torch.int64).clamp(min=0)
    runstart = keep & (_prev_kept(keep, ccid) != ccid)
    runend = keep & (_next_kept(keep, ccid) != ccid)
    rs_lanes, rvalid = _mask_lanes(runstart, RUN_LANES)
    re_lanes, _ = _mask_lanes(runend, RUN_LANES)
    kc = keep.to(torch.int64).cumsum(dim=1)

    def g(a, lanes):
        return a.gather(1, lanes).to(torch.int32)

    count = torch.where(
        rvalid, kc.gather(1, re_lanes) - kc.gather(1, rs_lanes) + 1, 0
    ).to(torch.int32)
    return (
        rvalid,
        g(ccid, rs_lanes),
        count,
        g(cpos, rs_lanes),
        g(cpos, re_lanes),
        g(rposw, rs_lanes),
        g(rposw, re_lanes),
    )
