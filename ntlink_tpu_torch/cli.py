"""Command line of the PyTorch port.

    python -m ntlink_tpu_torch scaffold target=assembly.fa reads='r1.fq.gz r2.fq.gz'
    python -m ntlink_tpu_torch scaffold gap_fill target=... reads=...
    python -m ntlink_tpu_torch pair target=... reads=... backend=hybrid t=4
    python -m ntlink_tpu_torch run_rounds_gaps target=... reads=... rounds=3
    python -m ntlink_tpu_torch fac scaffolds.fa | liftover agp=... mappings=...
    python -m ntlink_tpu_torch clean target=... | version

The targets, parameter names and parsing of ``ntlink_tpu.cli``. `pair`, `scaffold`,
`gap_fill`, `run_rounds` and `run_rounds_gaps` sketch and map on the CUDA
card and exit non-zero when there is none. backend=jax runs on the card
alone; backend=auto maps the reads on the card and, with t > 1 (the
default t=4), sketches the contigs on the card and the host's t C threads
at once; backend=hybrid splits both the contig sketch and the read mapping
between the card and the host's C path (hybrid_host_frac pins the read
mapping's host share; the contig sketch's split stays adaptive).
backend=numpy asks for the host by name: it resolves no device and runs
with none visible; it is never taken because a card is missing. With several visible cards the read batches split over them with
the index replicated on each, or hash-sharded over a (data, idx) grid with
index_sharding=hash [idx_shards=N]; with one card hash runs replicated.
v=1 prints the stage trace and writes <prefix>.trace.json;
NTLINK_TORCH_PROFILE=<dir> adds one torch.profiler Chrome trace per stage.
NTLINK_NUM_PROCESSES, NTLINK_PROCESS_ID and NTLINK_GROUP_DIR (a shared
directory) or NTLINK_COORDINATOR (host:port, torch.distributed over gloo)
start one of several processes that split the read files. `fac`,
`liftover`, `clean`, `extra_clean` and `version` are host code and need no
card.
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

HELP = f"""ntlink-tpu v{__version__} (PyTorch port): long-read scaffolding on a CUDA card

Usage: python -m ntlink_tpu_torch <target> [<target> ...] key=value ...
       (./ntLink_torch and ./ntLink_rounds_torch, or `ntlink-torch` once
       installed, take the same arguments)

Targets:
  scaffold          scaffold the assembly (add `gap_fill` to also patch gaps)
  pair              mapping + scaffold graph only
  run_rounds        iterative rounds (rounds=N, default 5)
  run_rounds_gaps   iterative rounds with gap-filling
  fac               abyss-fac-equivalent contiguity stats over FASTA files
  liftover          lift a verbose_mapping file over an AGP
                    (agp=... mappings=... out=... k=32; standalone
                    equivalent of the reference ntlink_liftover_mappings.py)
  clean             remove intermediate files (extra_clean: every artifact)
  version / help

Required: target=<assembly fasta>  reads='<read files ...>'
Common options (reference-compatible defaults):
  k=32 w=100 z=1000 n=1 max_n=10 g=20 G=-1 a=1 f=10 x=0 t=4
  overlap=True conservative=True sensitive=False repeats=False
  merge_gap=0 small_k=15 small_w=5 gap_k=20 gap_w=10 soft_mask=False
  prefix=<target>.k<k>.w<w>.z<z>  paf=False verbose=True
  ntlink_pairs_tsv=False stringent=False
Engine options:
  backend=auto|jax|numpy|hybrid  (jax: the card alone; auto: reads on the
                            card, contigs on the card and t C threads at
                            once when t > 1; numpy: the host by name, no
                            card needed; hybrid splits contigs and reads
                            card+host adaptively, and hybrid_host_frac=0..1
                            pins the reads' static share; default auto,
                            hybrid_host_frac=-1)
  batch_bases=8000000       bases per device batch
  index_sharding=replicated|hash  (several cards: the index on each, or
                            hash-sharded over a (data, idx) grid;
                            default replicated; one card runs replicated)
  idx_shards=0              shards of the hash-sharded index (0: the largest
                            power of two, up to 4, that divides the cards)
  v=0                       1: print the stage trace (wall, CPU, peak RSS)
                            and write <prefix>.trace.json; spans nest
                            (index/read, index/parse, index/dedup,
                            contig-sketch/render, /card, /host, /tail;
                            table/build, table/upload), each with its
                            start, parent and thread, and each shows up as
                            an ntlink/<span> range in any torch profile
Environment:
  NTLINK_TORCH_PROFILE=<dir>  when tracing, one torch.profiler Chrome trace
                            per top-level stage under <dir>/<stage>/trace.json
  NTLINK_TIMING=1           per-phase wall seconds of each read stream on
                            stderr (`# ntlink timing: key=seconds/spans`),
                            and CPU seconds of the phases timed once a
                            batch or group and of the main and reader
                            threads (`# ntlink cpu:`); phases by thread:
                            main reader_pull read_prep
                            host_remap pack feed_enqueue_wait flush_join
                            group_gather chain_render verbose_write tally;
                            feeder h2d_put dispatch copy_back
                            drain_enqueue_wait; drainer drain_flat_wait
                            drain_decode; reader reader_parse (the group
                            keys show up as ntlink/<key> profile ranges)
  NTLINK_PIPE_DEPTH=4       read batches in flight between the stream's
                            producer, feeder and drainer threads
  NTLINK_NUM_PROCESSES=N NTLINK_PROCESS_ID=i  one of N processes that split
                            the read files, joined through
                            NTLINK_GROUP_DIR=<shared dir> or
                            NTLINK_COORDINATOR=host:port (torch.distributed,
                            gloo)
The device targets (pair, scaffold, gap_fill, run_rounds, run_rounds_gaps)
exit 2 without a CUDA card unless backend=numpy; fac, liftover, clean,
extra_clean and version are host code.
"""


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
    """Run the device targets on `device` (`pipeline.split_devices`: None
    for every visible card, a device, a sequence of devices, or
    `device.HOST_ONLY` with backend=numpy) in ``ntlink_tpu.cli``'s order of
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
        print(HELP)
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

    from . import device, pipeline, tracing

    try:
        pipeline.check_supported(cfg)
        # backend=numpy is the host by name: no device is looked for
        dev = (device.HOST_ONLY if cfg.backend == "numpy"
               else device.resolve("cuda"))
    except (RuntimeError, ValueError) as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return 2
    if cfg.v:
        tracing.enable()
    print("ntlink_tpu_torch parameters:")
    for field in ("target", "reads", "k", "w", "t", "z", "n", "max_n", "g",
                  "G", "merge_gap", "a", "f", "x", "overlap",
                  "conservative", "sensitive", "repeats", "soft_mask",
                  "verbose", "paf", "pairs_tsv", "backend",
                  "hybrid_host_frac", "index_sharding", "idx_shards", "v"):
        print(f"\t{field}={getattr(cfg, field)}")
    print(f"\tprefix={cfg.resolved_prefix()}")
    # what the knobs ask for; the mapper's own line says what ran (the
    # contig-count gate needs the index)
    prechained, runs_only = pipeline.requested_modes(cfg)
    print(f"\tprechained={prechained}")
    print(f"\truns_only={runs_only}")
    if dev == device.HOST_ONLY:
        print("\tdevice=none (backend=numpy runs on the host)")
        dispatch(targets, cfg, rounds, dev)
        return 0
    n_cards = torch.cuda.device_count()
    print(f"\tdevice={dev} ({torch.cuda.get_device_name(dev)}); "
          f"{n_cards} visible")
    # None: the contig sketch on the first card, the read mapper on all
    dispatch(targets, cfg, rounds, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
