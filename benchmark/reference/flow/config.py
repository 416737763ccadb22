"""Run configuration for the scaffolding pipeline.

One dataclass is the single config surface; defaults mirror the reference
pipeline's knobs (reference ntLink:8-101) so a reference user can switch
without relearning parameters.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class ScaffoldConfig:
    """All pipeline parameters. Field names follow the reference CLI."""

    target: str = ""
    reads: List[str] = dataclasses.field(default_factory=list)

    k: int = 32            # k-mer size for mapping sketches
    w: int = 100           # minimizer window for mapping sketches
    t: int = 4             # host worker threads (IO / decompress)
    z: int = 1000          # minimum contig length to scaffold
    n: int = 1             # minimum graph edge weight
    max_n: int = 10        # upper bound of the edge-weight sweep
    g: int = 20            # minimum gap size
    G: int = -1            # maximum gap size (-1 = unbounded)
    merge_gap: int = 0     # gap size placed between trimmed overlapping scaffolds
    a: int = 1             # minimum anchoring reads per edge
    f: int = 10            # max contigs per run for full transitive tally
    x: float = 0.0         # mapping-block span fudge factor
    overlap: bool = True   # run overlap detection/trim
    conservative: bool = True
    sensitive: bool = False
    repeats: bool = False  # repeat-filter read sketches
    verbose: bool = True   # write verbose_mapping.tsv
    paf: bool = False      # write PAF-like mappings
    pairs_tsv: bool = False

    small_k: int = 15      # overlap-stage sketch
    small_w: int = 5
    gap_k: int = 20        # gap-fill re-mapping sketch
    gap_w: int = 10
    soft_mask: bool = False
    stringent: bool = False

    prefix: Optional[str] = None   # defaults to <target>.k<k>.w<w>.z<z>
    checkpoint: Optional[str] = None  # explicit mapping checkpoint (-c)

    v: int = 0             # v=1: per-stage time/RSS tracing (reference ntLink:100)

    # engine knobs (no reference analogue)
    backend: str = "auto"          # "auto" | "jax" | "numpy" | "hybrid"
    hybrid_host_frac: float = -1.0  # hybrid: host share in [0,1]; <0 = adaptive
    batch_bases: int = 8_000_000   # device batch budget in bases
    index_sharding: str = "replicated"  # "replicated" | "hash" (2-D mesh)
    idx_shards: int = 0            # hash-sharded table shards (0 = auto)

    def resolved_prefix(self) -> str:
        if self.prefix:
            return self.prefix
        return f"{self.target}.k{self.k}.w{self.w}.z{self.z}"

    def out_scaffolds(self) -> str:
        return f"{self.target}.k{self.k}.w{self.w}.z{self.z}.ntLink.scaffolds.fa"
