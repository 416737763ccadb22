"""Scaffold FASTA renderer — replaces external ABySS `MergeContigs -k2`.

Contract (verified on the reference goldens): for each path line, concatenate
the oriented contig sequences with a gap token ``gN`` contributing ``g-1``
N characters (the k=2 path convention: one base of notional overlap per
join); header is ``>{path_id} {sequence_length} 0 {comma-joined path}``.
Input sequences that appear in no path are passed through unchanged as
``>{name} {length}``.
"""
from __future__ import annotations

from .pathio import gap_size, is_gap, read_path_file
from .fastx import reverse_complement, stream_fastx


def merge_contigs(
    fasta_path: str, path_file: str, out_path: str
) -> None:
    """Streaming render: the header's length field is computed
    arithmetically and each oriented piece is written as produced, so the
    peak footprint is the input dict plus ONE contig-sized transient —
    never a whole-scaffold string (a 3 Gbase single-scaffold render
    previously held the parts list + its join = ~2 extra genome copies,
    the pipeline's peak-RSS stage at human scale)."""
    sequences = {rec.name: rec.seq for rec in stream_fastx(fasta_path)}
    used = set()
    with open(out_path, "w") as out:
        for path_id, tokens in read_path_file(path_file):
            length = sum(
                gap_size(t) - 1 if is_gap(t) else len(sequences[t[:-1]])
                for t in tokens
            )
            # paths longer than 3 tokens are abbreviated "first,...,last"
            if len(tokens) > 3:
                pretty = f"{tokens[0]},...,{tokens[-1]}"
            else:
                pretty = ",".join(tokens)
            out.write(f">{path_id} {length} 0 {pretty}\n")
            overlap_join = False
            for token in tokens:
                if is_gap(token):
                    n = gap_size(token) - 1
                    out.write("N" * n)
                    overlap_join = n == 0
                else:
                    name, ori = token[:-1], token[-1]
                    used.add(name)
                    seq = sequences[name]
                    seq = reverse_complement(seq) if ori == "-" else seq
                    if overlap_join and seq:
                        seq = seq[0].lower() + seq[1:]
                        overlap_join = False
                    out.write(seq)
            out.write("\n")
        for name, seq in sequences.items():
            if name not in used:
                out.write(f">{name} {len(seq)}\n{seq}\n")
