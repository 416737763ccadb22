"""Gap patching with raw read sequence.

Behavioral contract: reference ntlink_patch_gaps.py. For every joined pair
with a real gap, pick the best-anchored supporting read, localize precise cut
points by re-sketching N-masked flanks and the masked read span at a small
(k, w), and splice the read segment into the gap (with pass-1 anchor fallback
unless --stringent). Emits the gap-filled FASTA and its AGP.

The reference's two btllib.Indexlr streams over temp-masked FASTA files
become in-memory sketch calls on the same masked strings.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import ScaffoldConfig
from .mapping import AnchorHit, chain_read_hits, parse_hits_string
from .ops import nthash_np
from .pathio import GAP_RE, read_path_file
from .pipeline import log
from .seqio import reverse_complement, stream_fastx


@dataclass
class ReadMapping:
    anchors: int
    hits: List[AnchorHit]
    orientation: str


class ScaffoldSeq:
    """Sequence + trim/cut bookkeeping (reference ScaffoldGaps:20-53)."""

    def __init__(self, seq: str):
        self.seq = seq
        self.length = len(seq)
        self.five_prime_cut = 0
        self.three_prime_cut = self.length
        self.five_prime_trim = 0
        self.three_prime_trim = self.length

    def cut_coordinates(self) -> Tuple[int, int]:
        return (
            max(self.five_prime_trim, self.five_prime_cut),
            min(self.three_prime_trim, self.three_prime_cut),
        )

    def cut_sequence(self, ori: str) -> str:
        start, end = self.cut_coordinates()
        seq = self.seq[start:end]
        return reverse_complement(seq) if ori == "-" else seq


class GapPair:
    """State for one path join being filled (reference PairInfo:55-92)."""

    def __init__(self, gap_size: int):
        self.gap_size = gap_size
        self.mapping_reads: set = set()
        self.chosen_read: Optional[str] = None
        self.source_ctg_cut: Optional[int] = None
        self.source_read_cut: Optional[int] = None
        self.target_ctg_cut: Optional[int] = None
        self.target_read_cut: Optional[int] = None
        self.old_anchor_used = False

    def read_cut_span(self, ori: str) -> Tuple[int, int]:
        if ori == "-":
            return self.target_read_cut, self.source_read_cut
        return self.source_read_cut, self.target_read_cut

    def cut_read_sequence(self, reads: Dict[str, str], ori: str) -> str:
        start, end = self.read_cut_span(ori)
        seq = reads[self.chosen_read][start:end]
        return reverse_complement(seq) if ori == "-" else seq


def flip_pair(source: str, target: str) -> Tuple[str, str]:
    flip = lambda n: n[:-1] + ("-" if n[-1] == "+" else "+")
    return flip(target), flip(source)


def read_pairs_from_path(path_file: str, min_gap: int) -> Dict[Tuple[str, str], GapPair]:
    pairs: Dict[Tuple[str, str], GapPair] = {}
    for _, tokens in read_path_file(path_file):
        for i, j, k in zip(tokens, tokens[1:], tokens[2:]):
            m = GAP_RE.match(j)
            if m and int(m.group(1)) > min_gap:
                # -1: abyss-scaffold's +1 path-file gap bias
                pairs[(i, k)] = GapPair(int(m.group(1)) - 1)
    return pairs


def _orientation(hits: List[AnchorHit]) -> Optional[str]:
    if all(h.ctg_strand == h.read_strand for h in hits):
        return "+"
    if all(h.ctg_strand != h.read_strand for h in hits):
        return "-"
    return None


def _monotonic(hits: List[AnchorHit]) -> bool:
    inc = all(a.ctg_pos < b.ctg_pos for a, b in zip(hits, hits[1:]))
    dec = all(a.ctg_pos > b.ctg_pos for a, b in zip(hits, hits[1:]))
    return inc or dec


def load_read_mappings(
    mappings_file: str, pairs: Dict[Tuple[str, str], GapPair]
) -> Dict[str, dict]:
    """Collect per-read mapping info for reads supporting path pairs
    (reference read_verbose_mappings + tally_contig_mapping_info).

    Reads are pre-filtered before any per-anchor parsing: a read can only
    support a gap pair if at least two of its rows map contigs that appear
    in `pairs`, so everything else skips the (expensive) full hit parse —
    the bulk of the file at assembly scale."""
    read_info: Dict[str, dict] = {}
    relevant = set()
    for a, b in pairs:
        relevant.add(a[:-1])
        relevant.add(b[:-1])

    def process(read_id: str, rows: List[List[str]]) -> None:
        if sum(1 for f in rows if f[1] in relevant) < 2:
            return
        per_ctg: Dict[str, ReadMapping] = {}
        order: List[str] = []
        length = None
        for _, ctg, anchors, hits_text in rows:
            hits = parse_hits_string(hits_text)
            ori = _orientation(hits)
            if ori is None or not _monotonic(hits):
                continue
            per_ctg[ctg] = ReadMapping(int(anchors), hits, ori)
            order.append(ctg + ori)
            length = hits[-1].read_pos
        added = False
        for i in range(len(order)):
            for j in range(i + 1, len(order)):
                key = (order[i], order[j])
                if key in pairs:
                    pairs[key].mapping_reads.add(read_id)
                    added = True
                rc = flip_pair(*key)
                if rc in pairs:
                    pairs[rc].mapping_reads.add(read_id)
                    added = True
        if added:
            info = dict(per_ctg)
            info["length"] = length
            read_info[read_id] = info

    current, rows = None, []
    with open(mappings_file) as fh:
        for line in fh:
            fields = line.rstrip("\n").split("\t")
            if fields[0] != current and current is not None:
                process(current, rows)
                rows = []
            current = fields[0]
            rows.append(fields)
    if current is not None:
        process(current, rows)
    return read_info


def estimate_gap(
    source_hit: AnchorHit,
    source: str,
    target_hit: AnchorHit,
    target: str,
    sequences: Dict[str, ScaffoldSeq],
    k: int,
) -> int:
    s_name, s_ori = source[:-1], source[-1]
    t_name, t_ori = target[:-1], target[-1]
    a = (
        sequences[s_name].length - source_hit.ctg_pos - k
        if s_ori == "+"
        else source_hit.ctg_pos
    )
    b = (
        target_hit.ctg_pos
        if t_ori == "+"
        else sequences[t_name].length - target_hit.ctg_pos - k
    )
    return target_hit.read_pos - source_hit.read_pos - a - b


def _is_valid_read(
    source: str,
    target: str,
    read_id: str,
    mappings: Dict[str, dict],
    sequences: Dict[str, ScaffoldSeq],
    large_k: int,
) -> bool:
    if source[-1] != mappings[read_id][source[:-1]].orientation:
        assert target[-1] != mappings[read_id][target[:-1]].orientation
        source, target = flip_pair(source, target)
    s_hit = mappings[read_id][source[:-1]].hits[-1]
    t_hit = mappings[read_id][target[:-1]].hits[0]
    gap = estimate_gap(s_hit, source, t_hit, target, sequences, large_k)
    return abs(gap) <= mappings[read_id]["length"]


def choose_best_reads(
    pairs: Dict[Tuple[str, str], GapPair],
    mappings: Dict[str, dict],
    sequences: Dict[str, ScaffoldSeq],
    large_k: int,
) -> None:
    for (source, target), pair in pairs.items():
        candidates = [
            (
                rid,
                mappings[rid][source.strip("+-")].anchors,
                mappings[rid][target.strip("+-")].anchors,
            )
            for rid in pair.mapping_reads
        ]
        if not candidates:
            continue
        ranked = sorted(
            candidates, key=lambda c: (np.mean([c[1], c[2]]), c[0]), reverse=True
        )
        for rid, _, _ in ranked:
            if _is_valid_read(source, target, rid, mappings, sequences, large_k):
                pair.chosen_read = rid
                break


def adjust_ctg_cut(pos: int, read_ori: str, ctg_ori: str, k: int) -> int:
    """Reference assign_ctg_cut:291-299."""
    if read_ori == ctg_ori and ctg_ori == "-":
        return pos + k
    return pos


def adjust_read_cut(pos: int, read_ori: str, ctg_ori: str, k: int) -> int:
    """Reference assign_read_cut:301-308."""
    if read_ori != ctg_ori and ctg_ori == "+":
        return pos + k
    return pos


def find_pass1_cuts(
    pairs: Dict[Tuple[str, str], GapPair],
    mappings: Dict[str, dict],
    large_k: int,
) -> None:
    """Initial (pass-1) cut points from the mapping-stage anchors
    (reference find_masking_cut_points:311-342)."""
    for (source, target), pair in pairs.items():
        rid = pair.chosen_read
        if rid is None:
            continue
        s_map = mappings[rid][source.strip("+-")]
        s_ori = source[-1]
        s_hit = s_map.hits[-1] if s_map.orientation == s_ori else s_map.hits[0]
        t_map = mappings[rid][target.strip("+-")]
        t_ori = target[-1]
        t_hit = t_map.hits[0] if t_map.orientation == t_ori else t_map.hits[-1]
        pair.source_ctg_cut = adjust_ctg_cut(s_hit.ctg_pos, s_map.orientation, s_ori, large_k)
        pair.source_read_cut = adjust_read_cut(s_hit.read_pos, s_map.orientation, s_ori, large_k)
        pair.target_ctg_cut = adjust_ctg_cut(t_hit.ctg_pos, t_map.orientation, t_ori, large_k)
        pair.target_read_cut = adjust_read_cut(t_hit.read_pos, t_map.orientation, t_ori, large_k)


def _sketch_span(seq: str, lo: int, hi: int, k: int, w: int):
    """Minimizers of seq with everything outside [lo, hi) N-masked.

    Equivalent to sketching the masked string, but only the unmasked slice
    is hashed: k-mers touching an N are invalid, so the valid-k-mer list
    (and hence every window) is identical — positions just shift by `lo`.
    """
    lo = max(0, lo)
    hi = min(len(seq), hi)
    if hi - lo < k:
        import numpy as _np

        return nthash_np.Minimizers(
            _np.zeros(0, _np.uint64), _np.zeros(0, _np.int64), _np.zeros(0, bool)
        )
    mins = nthash_np.sketch_sequence(seq[lo:hi], k, w)
    return nthash_np.Minimizers(mins.hashes, mins.positions + lo, mins.forward)


def _sketch_masked_spans(
    named_spans: List[Tuple[str, str, int, int]], k: int, w: int
) -> Dict[str, Tuple[str, int, str]]:
    """Joint deduplicated minimizer table over masked flank sequences
    (reference read_btllib_minimizers:397-410). Hash keys are strings.
    Each entry is (name, seq, keep_lo, keep_hi)."""
    info: Dict[str, Tuple[str, int, str]] = {}
    dups = set()
    for name, seq, lo, hi in named_spans:
        mins = _sketch_span(seq, lo, hi, k, w)
        for h, p, f in zip(
            mins.hashes.tolist(), mins.positions.tolist(), mins.forward.tolist()
        ):
            key = str(h)
            if key in info:
                dups.add(key)
            else:
                info[key] = (name, int(p), "+" if f else "-")
    return {k_: v for k_, v in info.items() if k_ not in dups}


def _fallback(pair: GapPair, sequences, source, target) -> None:
    """Use pass-1 anchors for the scaffold cuts (reference :520-530)."""
    pair.old_anchor_used = True
    s_name, t_name = source.strip("+-"), target.strip("+-")
    if source[-1] == "+":
        sequences[s_name].three_prime_cut = pair.source_ctg_cut
    else:
        sequences[s_name].five_prime_cut = pair.source_ctg_cut
    if target[-1] == "+":
        sequences[t_name].five_prime_cut = pair.target_ctg_cut
    else:
        sequences[t_name].three_prime_cut = pair.target_ctg_cut


def refine_cuts(
    pairs: Dict[Tuple[str, str], GapPair],
    sequences: Dict[str, ScaffoldSeq],
    reads: Dict[str, str],
    cfg: ScaffoldConfig,
) -> None:
    """Pass 2: re-map each chosen read against its masked flanks at
    (gap_k, gap_w) to refine cut points (reference map_long_reads:412-489)."""
    gap_k, gap_w = cfg.gap_k, cfg.gap_w
    for (source, target), pair in pairs.items():
        if pair.chosen_read is None:
            continue
        s_name, s_ori = source.strip("+-"), source[-1]
        t_name, t_ori = target.strip("+-"), target[-1]

        s_seq = sequences[s_name].seq
        t_seq = sequences[t_name].seq
        s_lo, s_hi = (
            (pair.source_ctg_cut, len(s_seq)) if s_ori == "+"
            else (0, pair.source_ctg_cut)
        )
        t_lo, t_hi = (
            (0, pair.target_ctg_cut) if t_ori == "+"
            else (pair.target_ctg_cut, len(t_seq))
        )
        read_seq = reads[pair.chosen_read]
        r_lo = min(pair.source_read_cut, pair.target_read_cut)
        r_hi = max(pair.source_read_cut, pair.target_read_cut)

        mx_info = _sketch_masked_spans(
            [(s_name, s_seq, s_lo, s_hi), (t_name, t_seq, t_lo, t_hi)],
            gap_k, gap_w,
        )
        read_mins = _sketch_span(read_seq, r_lo, r_hi, gap_k, gap_w)
        r_masked_len = len(read_seq)
        hits = []
        for h, p, f in zip(
            read_mins.hashes.tolist(),
            read_mins.positions.tolist(),
            read_mins.forward.tolist(),
        ):
            entry = mx_info.get(str(h))
            if entry is not None:
                hits.append(
                    (
                        entry[0],
                        AnchorHit(int(h), entry[1], entry[2], p, "+" if f else "-"),
                    )
                )
        lengths = {name: seq.length for name, seq in sequences.items()}
        # NB: the reference pipeline never forwards -z/-x/--sensitive to the
        # gap-fill re-mapping (ntLink:266-269); its own defaults apply.
        runs = chain_read_hits(
            hits,
            r_masked_len,
            lengths,
            gap_k,
            z=1000,
            x=0.0,
            sensitive=False,
        )
        if len(runs) != 2:
            if cfg.stringent:
                pair.source_read_cut = pair.target_read_cut = None
            else:
                _fallback(pair, sequences, source, target)
            continue

        s_run = next((r for r in runs if r.contig == s_name), None)
        t_run = next((r for r in runs if r.contig == t_name), None)
        s_hit = t_hit = None
        s_read_ori = t_read_ori = None
        s_ok = t_ok = False
        if s_run is not None:
            s_read_ori = _orientation(s_run.hits)
            s_hit = s_run.hits[-1] if s_ori == s_read_ori else s_run.hits[0]
            s_ok = _monotonic(s_run.hits)
        if t_run is not None:
            t_read_ori = _orientation(t_run.hits)
            t_hit = t_run.hits[0] if t_ori == t_read_ori else t_run.hits[-1]
            t_ok = _monotonic(t_run.hits)
        if s_read_ori is None or t_read_ori is None or not s_ok or not t_ok:
            if cfg.stringent:
                pair.source_read_cut = pair.target_read_cut = None
            else:
                _fallback(pair, sequences, source, target)
            continue

        pair.source_ctg_cut = s_hit.ctg_pos
        pair.source_read_cut = adjust_read_cut(s_hit.read_pos, s_read_ori, s_ori, gap_k)
        if s_ori == "+":
            sequences[s_name].three_prime_cut = adjust_ctg_cut(
                s_hit.ctg_pos, s_read_ori, s_ori, gap_k
            )
        else:
            sequences[s_name].five_prime_cut = adjust_ctg_cut(
                s_hit.ctg_pos, s_read_ori, s_ori, gap_k
            )
        pair.target_ctg_cut = t_hit.ctg_pos
        pair.target_read_cut = adjust_read_cut(t_hit.read_pos, t_read_ori, t_ori, gap_k)
        if t_ori == "+":
            sequences[t_name].five_prime_cut = adjust_ctg_cut(
                t_hit.ctg_pos, t_read_ori, t_ori, gap_k
            )
        else:
            sequences[t_name].three_prime_cut = adjust_ctg_cut(
                t_hit.ctg_pos, t_read_ori, t_ori, gap_k
            )


def write_gap_filled(
    out_path: str,
    path_file: str,
    pairs: Dict[Tuple[str, str], GapPair],
    mappings: Dict[str, dict],
    sequences: Dict[str, ScaffoldSeq],
    reads: Dict[str, str],
    cfg: ScaffoldConfig,
    min_gap: int,
) -> Counter:
    """Render gap-filled scaffolds (reference print_gap_filled_sequences)."""
    counters: Counter = Counter()
    printed = set()
    with open(out_path, "w") as out:
        # streaming render (see merge.merge_contigs): each piece writes as
        # produced — no whole-scaffold string is ever materialized
        for path_id, tokens in read_path_file(path_file):
            out.write(f">{path_id}\n")
            overlap_gap = False
            for idx, tok in enumerate(tokens):
                m = GAP_RE.match(tok)
                if m:
                    gap = int(m.group(1))
                    counters["num_gaps"] += 1
                    if gap == 1:
                        overlap_gap = True
                        counters["overlap_pts"] += 1
                    if min_gap >= gap > 1:
                        counters["small_gaps"] += 1
                    key = (tokens[idx - 1], tokens[idx + 1])
                    if key not in pairs:
                        out.write("N" * (gap - 1))
                        continue
                    counters["potential_fills"] += 1
                    pair = pairs[key]
                    if pair.source_read_cut is None or pair.target_read_cut is None:
                        out.write("N" * pair.gap_size)
                    else:
                        ori = (
                            "-"
                            if mappings[pair.chosen_read][key[0].strip("+-")].orientation
                            != key[0][-1]
                            else "+"
                        )
                        fill = pair.cut_read_sequence(reads, ori)
                        out.write(fill.lower() if cfg.soft_mask else fill)
                        counters["filled_gaps"] += 1
                        counters[
                            "old_anchor_used" if pair.old_anchor_used else "new_anchor_used"
                        ] += 1
                else:
                    printed.add(tok.strip("+-"))
                    seq = sequences[tok.strip("+-")].cut_sequence(tok[-1])
                    if overlap_gap:
                        seq = seq[:1].lower() + seq[1:]
                        overlap_gap = False
                    out.write(seq)
            out.write("\n")
        for name, scaffold in sequences.items():
            if name not in printed:
                out.write(f">{name}\n{scaffold.seq}\n")
    return counters


def write_gap_fill_agp(
    out_path: str,
    path_file: str,
    pairs: Dict[Tuple[str, str], GapPair],
    mappings: Dict[str, dict],
    sequences: Dict[str, ScaffoldSeq],
) -> None:
    """AGP of the gap-filled assembly (reference print_agp:600-665)."""
    printed = set()
    with open(out_path, "w") as out:
        for path_id, tokens in read_path_file(path_file):
            start, component = 1, 1
            for idx, tok in enumerate(tokens):
                m = GAP_RE.match(tok)
                if m:
                    gap = int(m.group(1)) - 1
                    key = (tokens[idx - 1], tokens[idx + 1])
                    if key not in pairs:
                        # NB: the reference never bumps component here
                        if gap > 0:
                            out.write(
                                f"{path_id}\t{start}\t{start + gap - 1}\t{component}\t"
                                f"N\t{gap}\tscaffold\tyes\tpaired-ends\n"
                            )
                            start += gap
                        continue
                    pair = pairs[key]
                    if pair.source_read_cut is None or pair.target_read_cut is None:
                        out.write(
                            f"{path_id}\t{start}\t{start + gap - 1}\t{component}\t"
                            f"N\t{gap}\tscaffold\tyes\tpaired-ends\n"
                        )
                        start += gap
                    else:
                        ori = (
                            "-"
                            if mappings[pair.chosen_read][key[0].strip("+-")].orientation
                            != key[0][-1]
                            else "+"
                        )
                        r_start, r_end = pair.read_cut_span(ori)
                        if not r_end >= r_start + 1:
                            continue  # read fully eroded
                        out.write(
                            f"{path_id}\t{start}\t{start + (r_end - r_start) - 1}\t"
                            f"{component}\tP\t{pair.chosen_read}\t{r_start + 1}\t"
                            f"{r_end}\t{ori}\n"
                        )
                        start += r_end - r_start
                else:
                    printed.add(tok.strip("+-"))
                    c_start, c_end = sequences[tok.strip("+-")].cut_coordinates()
                    if not c_end >= c_start + 1:
                        continue  # scaffold fully eroded
                    out.write(
                        f"{path_id}\t{start}\t{start + (c_end - c_start) - 1}\t"
                        f"{component}\tW\t{tok.strip('+-')}\t{c_start + 1}\t{c_end}\t"
                        f"{tok[-1]}\n"
                    )
                    start += c_end - c_start
                component += 1
        for name, scaffold in sequences.items():
            if name in printed:
                continue
            c_start, c_end = scaffold.cut_coordinates()
            out.write(
                f"{name}\t{c_start + 1}\t{c_end}\t1\tW\t{name}\t{c_start + 1}\t"
                f"{c_end}\t+\n"
            )


def gap_fill_stage(cfg: ScaffoldConfig) -> str:
    """Full gap-fill stage over the trimmed layout. Returns the output path."""
    prefix = cfg.resolved_prefix()
    path_file = f"{prefix}.trimmed_scafs.path"
    mappings_file = f"{prefix}.verbose_mapping.tsv"
    trims_file = f"{prefix}.trimmed_scafs.tsv"
    out_path = f"{cfg.target}.k{cfg.k}.w{cfg.w}.z{cfg.z}.ntLink.scaffolds.gap_fill.fa"

    min_gap = 1 + 1  # reference --min_gap 1, then +1 (ntLink:268, patch_gaps:789)
    log("Gap-filling", path_file)
    pairs = read_pairs_from_path(path_file, min_gap)
    mappings = load_read_mappings(mappings_file, pairs)

    sequences = {
        rec.name: ScaffoldSeq(rec.seq) for rec in stream_fastx(cfg.target)
    }
    with open(trims_file) as fh:
        for line in fh:
            name, start, end = line.rstrip("\n").split("\t")
            sequences[name].five_prime_trim = int(start)
            sequences[name].three_prime_trim = int(end)

    choose_best_reads(pairs, mappings, sequences, cfg.k)

    wanted = {p.chosen_read for p in pairs.values() if p.chosen_read is not None}
    reads: Dict[str, str] = {}
    # scan read files for the chosen reads with parallel decompression
    # (reference uses threaded btllib SeqReader, ntlink_patch_gaps.py:264-273);
    # only WANTED records decode to str — the sweep visits every read of a
    # 10x dataset to keep a few hundred, and per-record str decode +
    # namedtuple construction was over half the scan's cost at 30 Gbase
    from .seqio.fastx import prefetch_files, scan_selected_reads

    def selected(path):
        return scan_selected_reads(path, wanted)

    for _, rec_iter in prefetch_files(cfg.reads, selected, threads=cfg.t):
        for name, seq in rec_iter:
            reads[name] = seq

    find_pass1_cuts(pairs, mappings, cfg.k)
    refine_cuts(pairs, sequences, reads, cfg)

    counters = write_gap_filled(
        out_path, path_file, pairs, mappings, sequences, reads, cfg, min_gap
    )
    write_gap_fill_agp(out_path + ".agp", path_file, pairs, mappings, sequences)

    log("Gap filling summary:")
    for label, key in [
        ("detected sequence joins", "num_gaps"),
        ("overlap sequence joins", "overlap_pts"),
        ("gaps smaller than threshold", "small_gaps"),
        ("potentially fillable gaps", "potential_fills"),
        ("filled gaps", "filled_gaps"),
        ("pass 2 anchors used", "new_anchor_used"),
        ("pass 1 anchors used", "old_anchor_used"),
    ]:
        log(f"  {label}: {counters[key]}")
    return out_path
