"""Command line of the PyTorch port.

    python -m ntlink_tpu_torch scaffold target=assembly.fa reads='r1.fq.gz r2.fq.gz'
    python -m ntlink_tpu_torch scaffold gap_fill target=... reads=...
    python -m ntlink_tpu_torch pair target=... reads=... backend=hybrid t=4
    python -m ntlink_tpu_torch run_rounds_gaps target=... reads=... rounds=3
    python -m ntlink_tpu_torch fac scaffolds.fa | liftover agp=... mappings=...
    python -m ntlink_tpu_torch clean target=... | version

The targets, parameter names and parsing of ``ntlink_tpu.cli`` (its
`parse_args` and `build_config` are reused). `pair`, `scaffold`,
`gap_fill`, `run_rounds` and `run_rounds_gaps` sketch and map on the CUDA
card and exit non-zero when there is none; backend=auto and backend=jax
run on the card alone, backend=hybrid splits the contig sketch and the
read mapping between the card and the host's C path (hybrid_host_frac pins
the host's share). `fac`, `liftover`, `clean`, `extra_clean` and `version`
are host code and run as ``ntlink_tpu.cli`` runs them. Not yet ported, and
refused: v (tracing), backend=numpy (use ``python -m ntlink_tpu``),
index_sharding=hash, idx_shards, multi-process runs.
"""
from __future__ import annotations

import sys
from typing import List

import torch

from ntlink_tpu import cli as host_cli
from ntlink_tpu.cli import TARGETS, build_config, parse_args
from ntlink_tpu.config import ScaffoldConfig

#: targets that run entirely on the host, as ntlink_tpu.cli runs them
HOST_TARGETS = {"version", "fac", "liftover", "clean", "extra_clean"}
ROUNDS_TARGETS = {"run_rounds", "run_rounds_gaps"}


def parse(argv: List[str]):
    """(targets, config, rounds) of a command line, as ``ntlink_tpu.cli``
    builds them (rounds= only with a rounds target)."""
    targets, params = parse_args(argv)
    allowed = frozenset(("rounds",)) if ROUNDS_TARGETS & set(targets) \
        else frozenset()
    return targets, build_config(params, allowed), int(params.get("rounds", 5))


def dispatch(targets: List[str], cfg: ScaffoldConfig, rounds: int,
             device) -> str:
    """Run the device targets on `device` in ``ntlink_tpu.cli``'s order of
    precedence; returns the path of the final artifact."""
    from . import pipeline

    if "run_rounds" in targets:
        return pipeline.run_rounds(cfg, rounds, gap_fill=False, device=device)
    if "run_rounds_gaps" in targets:
        return pipeline.run_rounds(cfg, rounds, gap_fill=True, device=device)
    if "pair" in targets:
        return pipeline.pair_stage(cfg, device=device)
    return pipeline.run_scaffold(
        cfg, gap_fill="gap_fill" in targets, device=device
    )


def main(argv: List[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    targets, _ = parse_args(argv)
    if not targets or "help" in targets:
        print(__doc__)
        return 0
    if HOST_TARGETS & set(targets):
        return host_cli.main(argv)
    unknown = [t for t in targets if t not in TARGETS]
    if unknown:
        print(f"ERROR: unknown target(s): {' '.join(unknown)}", file=sys.stderr)
        return 2
    targets, cfg, rounds = parse(argv)
    if not cfg.target or not cfg.reads:
        print("ERROR: Must set target and reads", file=sys.stderr)
        return 2

    from . import device, pipeline

    try:
        pipeline.check_supported(cfg)
        dev = device.resolve("cuda")
    except (RuntimeError, ValueError) as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 2
    print("ntlink_tpu_torch parameters:")
    for field in ("target", "reads", "k", "w", "t", "z", "n", "a", "f", "x",
                  "overlap", "sensitive", "repeats", "verbose", "paf",
                  "pairs_tsv", "backend", "hybrid_host_frac"):
        print(f"\t{field}={getattr(cfg, field)}")
    print(f"\tprefix={cfg.resolved_prefix()}")
    # what the knobs ask for; the mapper's own line says what ran (the
    # contig-count gate needs the index)
    prechained, runs_only = pipeline.requested_modes(cfg)
    print(f"\tprechained={prechained}")
    print(f"\truns_only={runs_only}")
    print(f"\tdevice={dev} ({torch.cuda.get_device_name(dev)})")
    dispatch(targets, cfg, rounds, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
