"""ntlink_tpu_torch: the PyTorch + CUDA port of ntlink_tpu, for NVIDIA Hopper.

The JAX package ``ntlink_tpu`` stays the reference, and this package imports
nothing of it: it carries its own copies of the host modules (sequence IO,
the native C sources under ``native/``, index, chaining, tally, graph,
layout, stitch, overlap, merge, gap-fill, liftover) under the same module
names, and ports the device layer. ``python -m ntlink_tpu_torch`` runs every
single-device target: the contig sketch stream and the read mapping on the
card (chaining on the device, per-anchor or O(runs) payloads, N rows,
backend=hybrid with the host's C path beside it). Every sketch runs in the
hand-written kernel ``csrc/sketch.cu``.
"""

__version__ = "0.1.0"
