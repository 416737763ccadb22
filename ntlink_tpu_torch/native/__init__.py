"""Native (C) components. Optional at runtime; every caller has a pure
Python fallback."""
from __future__ import annotations

_modules = {}


def _get(name: str):
    if name not in _modules:
        try:
            from . import build

            _modules[name] = build.load(name)
        except Exception:
            _modules[name] = None
    return _modules[name]


def fastx_module():
    """The compiled ntlink_fastx module, or None if unavailable."""
    return _get("ntlink_fastx")


def chain_module():
    """The compiled ntlink_chain module, or None if unavailable."""
    return _get("ntlink_chain")


def graph_module():
    """The compiled ntlink_graph module, or None if unavailable."""
    return _get("ntlink_graph")


def liftover_module():
    """The compiled ntlink_liftover module, or None if unavailable."""
    return _get("ntlink_liftover")


def sketch_module():
    """The compiled ntlink_sketch module, or None if unavailable."""
    return _get("ntlink_sketch")


def tsv_module():
    """The compiled ntlink_tsv module, or None if unavailable."""
    return _get("ntlink_tsv")
