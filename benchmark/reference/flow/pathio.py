"""Path-file grammar helpers.

A path file line is ``<id>\\t<ctg1±> <gap>N <ctg2±> ...`` with every gap
carrying the abyss-scaffold +1 bias. Path normalization and the oriented-name
flip follow the reference's determinism contract (ntlink_utils.py:79-88,
177-187).
"""
from __future__ import annotations

import re
from typing import Iterator, List, Tuple

GAP_RE = re.compile(r"^(\d+)N$")


def is_gap(token: str) -> bool:
    return bool(GAP_RE.match(token))


def gap_size(token: str) -> int:
    m = GAP_RE.match(token)
    if not m:
        raise ValueError(f"not a gap token: {token}")
    return int(m.group(1))


def flip_oriented(name: str) -> str:
    assert name[-1] in "+-"
    return name[:-1] + ("-" if name[-1] == "+" else "+")


def normalize_path_tokens(tokens: List[str]) -> List[str]:
    """Orient a token list so the lexicographically smaller end leads."""
    if tokens[0].strip("+-") < tokens[-1].strip("+-"):
        return tokens
    out = []
    for tok in reversed(tokens):
        out.append(tok if is_gap(tok) else flip_oriented(tok))
    return out


def read_path_file(path: str) -> Iterator[Tuple[str, List[str]]]:
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                continue
            yield parts[0], parts[1].split(" ")


def write_path_file(path: str, entries: List[Tuple[str, List[str]]]) -> None:
    with open(path, "w") as fh:
        for path_id, tokens in entries:
            fh.write(f"{path_id}\t{' '.join(tokens)}\n")
