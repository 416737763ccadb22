"""Command line of the PyTorch port.

    python -m ntlink_tpu_torch scaffold target=assembly.fa reads='r1.fq.gz r2.fq.gz'
    python -m ntlink_tpu_torch scaffold gap_fill target=... reads=...
    python -m ntlink_tpu_torch pair target=... reads=... backend=hybrid t=4
    python -m ntlink_tpu_torch run_rounds_gaps target=... reads=... rounds=3
    python -m ntlink_tpu_torch fac scaffolds.fa | liftover agp=... mappings=...
    python -m ntlink_tpu_torch clean target=... | version

The targets, parameter names and parsing of ``ntlink_tpu.cli``. `pair`, `scaffold`,
`gap_fill`, `run_rounds` and `run_rounds_gaps` sketch and map on the CUDA
card and exit non-zero when there is none; backend=auto and backend=jax
run on the card alone, backend=hybrid splits the contig sketch and the
read mapping between the card and the host's C path (hybrid_host_frac pins
the host's share). `fac`, `liftover`, `clean`, `extra_clean` and `version`
are host code and need no card. Not yet ported, and
refused: v (tracing), backend=numpy (use ``python -m ntlink_tpu``),
index_sharding=hash, idx_shards, multi-process runs.
"""
from __future__ import annotations

import sys
from typing import Dict, List

import torch

from . import __version__
from .config import ScaffoldConfig

TARGETS = {
    "scaffold",
    "pair",
    "gap_fill",
    "clean",
    "extra_clean",
    "run_rounds",
    "run_rounds_gaps",
    "fac",
    "liftover",
    "help",
    "version",
}

#: targets that run entirely on the host
HOST_TARGETS = {"version", "fac", "liftover", "clean", "extra_clean"}
ROUNDS_TARGETS = {"run_rounds", "run_rounds_gaps"}

_BOOL_KEYS = {
    "overlap",
    "conservative",
    "sensitive",
    "repeats",
    "verbose",
    "soft_mask",
    "ntlink_pairs_tsv",
    "paf",
    "stringent",
}
_INT_KEYS = {
    "k", "w", "t", "z", "n", "max_n", "g", "G", "merge_gap", "a", "f",
    "small_k", "small_w", "gap_k", "gap_w", "rounds", "batch_bases", "v",
    "idx_shards",
}
_FLOAT_KEYS = {"x", "hybrid_host_frac"}


def parse_args(argv: List[str]):
    targets: List[str] = []
    params: Dict[str, str] = {}
    for arg in argv:
        if arg in ("-B", "--always-make"):
            continue  # Make compatibility: we always rebuild requested stages
        if "=" in arg:
            key, value = arg.split("=", 1)
            params[key] = value
        else:
            targets.append(arg)
    return targets, params


#: parameters consumed by main() itself, not ScaffoldConfig fields; each is
#: only meaningful for specific targets (rounds -> run_rounds*, the rest ->
#: liftover) and rejected elsewhere so a stray knob never silently no-ops
_MAIN_KEYS = {"rounds", "agp", "mappings", "out"}


def build_config(
    params: Dict[str, str], allowed_main: frozenset = frozenset(("rounds",))
) -> ScaffoldConfig:
    cfg = ScaffoldConfig()
    for key, value in params.items():
        dest = {"ntlink_pairs_tsv": "pairs_tsv"}.get(key, key)
        if key == "reads":
            cfg.reads = value.split()
            continue
        if key == "target":
            cfg.target = value
            continue
        if key in _MAIN_KEYS:
            if key not in allowed_main:
                raise SystemExit(
                    f"ERROR: parameter {key}= is not valid for this target"
                )
            if key == "rounds":
                try:
                    int(value)  # still validated loudly
                except ValueError:
                    raise SystemExit(
                        f"ERROR: rounds= must be an integer, got {value!r}"
                    ) from None
            continue
        if not hasattr(cfg, dest):
            # fail loudly: a typo'd knob silently doing nothing teaches the
            # wrong lesson (every accepted knob is wired)
            raise SystemExit(f"ERROR: unknown parameter {key}")
        if key in _BOOL_KEYS:
            setattr(cfg, dest, value.strip() == "True")
        elif key in _INT_KEYS:
            setattr(cfg, dest, int(value))
        elif key in _FLOAT_KEYS:
            setattr(cfg, dest, float(value))
        else:
            setattr(cfg, dest, value)
    return cfg



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


def host_main(targets: List[str], params: Dict[str, str]) -> int:
    """The targets that need no device (`version`, `fac`, `liftover`,
    `clean`, `extra_clean`), with ``ntlink_tpu.cli.main``'s order of
    precedence, messages and exit codes."""
    if "version" in targets:
        print(f"ntlink-tpu v{__version__}")
        return 0

    if "fac" in targets:
        # abyss-fac-equivalent contiguity stats over FASTA files
        from .seqio import stream_fastx
        from .stats import FAC_HEADER, fac_row, non_n_length

        files = [t for t in targets if t != "fac"]
        print(FAC_HEADER)
        for path in files:
            lengths = [non_n_length(r.seq) for r in stream_fastx(path)]
            print(fac_row(lengths, path))
        return 0

    unknown = [t for t in targets if t not in TARGETS]
    if unknown:
        print(f"ERROR: unknown target(s): {' '.join(unknown)}", file=sys.stderr)
        return 2

    if "liftover" in targets:
        # standalone AGP liftover (reference ntlink_liftover_mappings.py)
        from .liftover import liftover_mappings

        agp, mappings = params.get("agp"), params.get("mappings")
        if not agp or not mappings:
            print("ERROR: liftover requires agp= and mappings=",
                  file=sys.stderr)
            return 2
        out = params.get("out", f"{mappings}.lifted.tsv")
        liftover_mappings(mappings, agp, out, int(params.get("k", 32)))
        print(f"Lifted mappings written to {out}")
        return 0

    from . import pipeline

    rounds_target = bool(ROUNDS_TARGETS & set(targets))
    cfg = build_config(
        params, frozenset(("rounds",)) if rounds_target else frozenset()
    )
    pipeline.clean_artifacts(cfg, extra="extra_clean" in targets)
    return 0


def main(argv: List[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    targets, params = parse_args(argv)
    if not targets or "help" in targets:
        print(__doc__)
        return 0
    if HOST_TARGETS & set(targets):
        return host_main(targets, params)
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
