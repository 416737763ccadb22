"""Command line of the PyTorch port.

    python -m ntlink_tpu_torch pair target=assembly.fa reads='r1.fq.gz r2.fq.gz'

Same parameter names and parsing as ``ntlink_tpu.cli`` (its `parse_args`
and `build_config` are reused). Only the `pair` target is ported; every
other target exits non-zero with "not yet ported: <target>". The mapping
runs on the CUDA card and exits non-zero when there is none.
"""
from __future__ import annotations

import sys
from typing import List

import torch

from ntlink_tpu.cli import TARGETS, build_config, parse_args
from ntlink_tpu.config import ScaffoldConfig

PORTED = {"pair"}


def pair_config(argv: List[str]) -> ScaffoldConfig:
    """The configuration `main` builds from a `pair` command line."""
    return build_config(parse_args(argv)[1], frozenset())


def main(argv: List[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    targets, params = parse_args(argv)
    if not targets or "help" in targets:
        print(__doc__)
        return 0
    unknown = [t for t in targets if t not in TARGETS]
    if unknown:
        print(f"ERROR: unknown target(s): {' '.join(unknown)}", file=sys.stderr)
        return 2
    not_ported = [t for t in targets if t not in PORTED]
    if not_ported:
        print(f"ERROR: not yet ported: {' '.join(not_ported)}",
              file=sys.stderr)
        return 2
    cfg = build_config(params, frozenset())
    if not cfg.target or not cfg.reads:
        print("ERROR: Must set target and reads", file=sys.stderr)
        return 2

    from . import device, pipeline

    try:
        pipeline.check_supported(cfg)
        dev = device.resolve("cuda")
    except (RuntimeError, pipeline.NotPorted) as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 2
    print("ntlink_tpu_torch parameters:")
    for field in ("target", "reads", "k", "w", "t", "z", "n", "a", "f", "x",
                  "sensitive", "verbose", "paf", "pairs_tsv"):
        print(f"\t{field}={getattr(cfg, field)}")
    print(f"\tprefix={cfg.resolved_prefix()}")
    print(f"\tdevice={dev} ({torch.cuda.get_device_name(dev)})")
    pipeline.pair_stage(cfg, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
