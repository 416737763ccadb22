"""Phase 8 of ``chip_smoke.py`` alone: the card named twice.

    python3 scripts/smoke_phase8_torch.py [--checkout DIR]

Runs the smoke's environment phase (the builds), writes the phase-7 draft
(the smoke's `SMALL` draft, reads in two files), maps it once on the card
named once as the reference, then runs phase 8 (`phase_replicas`): two
replicas, default and lean, the 1 x 2 hash grid plain and with
repeats=True, and the dryruns, each held byte for byte against the
reference, with its reads/s, launches, peak device memory and step graphs
on its log line. `--checkout` runs another checkout's smoke and package
(an unpacked `git archive` of an older commit, to compare two versions in
one chip call); the default is this script's own checkout. Needs a CUDA
device: without one it exits 1.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.checkout))
    import torch

    if not torch.cuda.is_available():
        print("smoke_phase8_torch: needs a CUDA device, and "
              "torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import chip_smoke as cs

    t0 = time.perf_counter()
    cs.phase_environment()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="ntlink_phase8_") as root:
        data = os.path.join(root, "data")
        os.makedirs(data)
        cs.write_dataset(data, label="phase 7", **cs.SMALL)
        cs.split_read_files(data)
        inputs = [os.path.join(data, f)
                  for f in ("target.fa", "reads1.fa", "reads2.fa")]
        one_pair = cs.make_dir(root, "one_pair", inputs)
        cs.card_pair(one_pair, cs.PAIR2_ARGV, dev,
                     "phase 7 (one process, pair)")
        t1 = time.perf_counter()
        launches = cs.phase_replicas(dev, root, data, one_pair)
    print(f"smoke_phase8_torch ({cs.__file__}): phase 8 "
          f"{time.perf_counter() - t1:.1f} s, all "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
