"""ntlink_tpu_torch: the PyTorch + CUDA port of ntlink_tpu, for NVIDIA Hopper.

The JAX package ``ntlink_tpu`` stays the reference; this package imports its
host modules (sequence IO, native C, index, chaining, tally, graph) and
ports only the device layer. Ported so far: the `pair` stage with host
chaining (``pipeline.pair_stage``, ``python -m ntlink_tpu_torch pair``),
whose sketch runs in the hand-written kernel ``csrc/sketch.cu``.
"""

__version__ = "0.1.0"
