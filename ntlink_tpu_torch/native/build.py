"""On-demand build of the native C modules.

Compiles each module from its source into this directory the first time it
is needed (no pybind11; plain CPython C API, zlib for the fastx reader).
Safe to fail: callers fall back to pure Python. Safe under concurrent
first use (several processes of one run starting at once): each compiles
to a name of its own and renames it into place, so no process ever loads
a half-written library. The sources and extension
names are those of ``ntlink_tpu/native``; a process that loads both
packages gets two module objects, each from its own directory (`load`
imports by file location and registers nothing in ``sys.modules``).
"""
from __future__ import annotations

import os
import subprocess
import sysconfig

_DIR = os.path.dirname(os.path.abspath(__file__))

MODULES = {
    "ntlink_fastx": ("fastxio.c", ["-lz"]),
    "ntlink_chain": ("chain.c", []),
    "ntlink_graph": ("graph.c", []),
    "ntlink_liftover": ("liftover.c", []),
    "ntlink_sketch": ("sketch.c", []),
    "ntlink_tsv": ("tsvparse.c", []),
}


def build(name: str = "ntlink_fastx", verbose: bool = False) -> str:
    """Compile (if needed) and return the extension path."""
    src_name, libs = MODULES[name]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(_DIR, f"{name}{suffix}")
    src = os.path.join(_DIR, src_name)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    include = sysconfig.get_paths()["include"]
    tmp = os.path.join(_DIR, f".{name}.{os.getpid()}{suffix}")
    cmd = [
        os.environ.get("CC", "cc"),
        "-O3",
        "-fPIC",
        "-shared",
        f"-I{include}",
        src,
        *libs,
        "-o",
        tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str = "ntlink_fastx"):
    """Import a native module, building it if necessary. May raise."""
    import importlib.util

    path = build(name)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
