"""Port tests run without the reference checkout.

``tests/conftest.py`` skips every module but two when the reference goldens
are missing. The tests here need no goldens: each compares the PyTorch port
with the JAX package on inputs made from a seed. So this hook, which runs
after that one, takes that one skip back off the items of this directory.
It also registers the `cuda` marker of tests that need an NVIDIA card, and
gives each pytest-xdist worker one PyTorch thread.
"""
import os

import pytest
import torch

_HERE = os.path.dirname(os.path.abspath(__file__)) + os.sep
_GOLDEN_SKIP = "reference goldens not available"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)"
    )
    # every xdist worker is a process of its own; with PyTorch's default of
    # one thread per core each, the workers' thread pools oversubscribe the
    # cores and the plain versions' tensor ops slow down several-fold
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(config, items):
    for item in items:
        if not str(item.path).startswith(_HERE):
            continue
        item.own_markers[:] = [
            m for m in item.own_markers
            if not (m.name == "skip" and m.kwargs.get("reason") == _GOLDEN_SKIP)
        ]
