"""Assembly contiguity statistics (abyss-fac-compatible).

Length metric follows abyss-fac as observed on the reference goldens: the
non-N base count of each sequence, stats over sequences >= 500 bp, columns
``n  n:500  L50  min  N75  N50  N25  E-size  max  sum  name``.
"""
from __future__ import annotations

from typing import Iterable


def non_n_length(seq: str) -> int:
    upper = seq.upper()
    return len(seq) - upper.count("N")


def fac_row(lengths: Iterable[int], name: str, threshold: int = 500) -> str:
    all_lengths = list(lengths)
    big = sorted((l for l in all_lengths if l >= threshold), reverse=True)
    if not big:
        return "\t".join(
            [str(len(all_lengths)), "0", "0", "0", "0", "0", "0", "0", "0", "0", name]
        )
    total = sum(big)

    def n_stat(fraction: float) -> int:
        goal = total * fraction
        cum = 0
        for l in big:
            cum += l
            if cum >= goal:
                return l
        return big[-1]

    l50 = 0
    cum = 0
    for i, l in enumerate(big):
        cum += l
        if cum >= total * 0.5:
            l50 = i + 1
            break
    e_size = sum(l * l for l in big) // total
    return "\t".join(
        str(v)
        for v in [
            len(all_lengths),
            len(big),
            l50,
            big[-1],
            n_stat(0.75),
            n_stat(0.5),
            n_stat(0.25),
            e_size,
            big[0],
            total,
            name,
        ]
    )


FAC_HEADER = "n\tn:500\tL50\tmin\tN75\tN50\tN25\tE-size\tmax\tsum\tname"


def fac_table(lengths: Iterable[int], name: str) -> str:
    return FAC_HEADER + "\n" + fac_row(lengths, name) + "\n"
