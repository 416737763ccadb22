"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout; see ``README.md``.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    # every build and kernel cache of the run stays in the checkout, at a
    # fixed path (the port builds its own into ntlink_tpu_torch/_build and
    # ntlink_tpu_torch/native)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.pop("NTLINK_TORCH_PROFILE", None)
    os.environ.pop("NTLINK_TIMING", None)
    os.environ.setdefault("USE_FLAX", "0")
    from benchmark.harness import main

    sys.exit(main())
