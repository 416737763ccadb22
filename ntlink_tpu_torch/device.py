"""Device selection for the PyTorch port.

Counterpart of ``ntlink_tpu/jax_setup.py``: where the JAX package picks a
platform for XLA, the port resolves one explicit ``torch.device``. The
default is the CUDA card, and asking for it without one raises: there is no
silent CPU fallback. The plain-PyTorch CPU path runs only when a caller
(the tests) asks for ``device="cpu"`` by name.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``torch.device`` for `device` (default ``"cuda"``); raises when a
    CUDA device is asked for and ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ntlink_tpu_torch needs a CUDA device, and "
            "torch.cuda.is_available() is False"
        )
    return dev
