"""Device selection for the PyTorch port.

Counterpart of ``ntlink_tpu/jax_setup.py``: where the JAX package picks a
platform for XLA, the port resolves one explicit ``torch.device``. The
default is the CUDA card, and asking for it without one raises: there is no
silent CPU fallback. The plain-PyTorch CPU path runs only when a caller
(the tests) asks for ``device="cpu"`` by name. backend=numpy is the one
entry that takes no device at all: its callers pass `HOST_ONLY`, which is
never resolved.
"""
from __future__ import annotations

from typing import List

import torch

#: what backend=numpy passes where the other backends pass a device: the
#: run stays on the host and must not touch a device (`resolve` refuses it)
HOST_ONLY = "host-only"


def resolve(device=None) -> torch.device:
    """``torch.device`` for `device` (default ``"cuda"``); raises when a
    CUDA device is asked for and ``torch.cuda.is_available()`` is False."""
    if device == HOST_ONLY:
        raise ValueError("a host-only run resolves no device")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ntlink_tpu_torch needs a CUDA device, and "
            "torch.cuda.is_available() is False"
        )
    return dev


def resolve_all(device=None, devices=None) -> List[torch.device]:
    """The devices a mapper runs on. `devices` (a sequence, which may name
    one device several times) wins; else a given `device` alone; else
    every visible CUDA device, as ``DeviceMapper`` takes
    ``jax.local_devices()``."""
    if devices is not None:
        out = [resolve(d) for d in devices]
        if not out:
            raise ValueError("devices must name at least one device")
        return out
    if device is not None:
        return [resolve(device)]
    resolve("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
