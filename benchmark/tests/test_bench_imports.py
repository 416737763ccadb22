"""The import guard: nothing under benchmark/ names jax, jaxlib, flax or the
JAX package (top-level module names compared whole: the port's name begins
with the JAX package's); only the drivers and the tests import the port,
and the reference imports nothing of it nor of the harness."""
import ast
import os

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "ntlink_tpu"}


def imports(path):
    """(top-level name, dotted name) of every absolute import; relative
    imports as ('.', text)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                out.append((".", "." * node.level + (node.module or "")))
            else:
                out.append((node.module.split(".")[0], node.module))
    return out


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), BENCH)


def test_no_module_imports_jax_or_the_jax_package():
    for rel in sources():
        for top, name in imports(os.path.join(BENCH, rel)):
            assert top not in FORBIDDEN, (rel, name)


def test_only_drivers_and_tests_import_the_port():
    for rel in sources():
        if rel.startswith(("drivers" + os.sep, "tests" + os.sep)):
            continue
        for top, name in imports(os.path.join(BENCH, rel)):
            assert top != "ntlink_tpu_torch", (rel, name)


def test_reference_imports_only_numpy_the_stdlib_and_itself():
    import sys

    for rel in sources():
        if not rel.startswith("reference" + os.sep):
            continue
        depth = rel.count(os.sep)   # reference/x.py: 1
        for top, name in imports(os.path.join(BENCH, rel)):
            if top == ".":   # relative: it may not climb out of reference/
                assert len(name) - len(name.lstrip(".")) <= depth, (rel,
                                                                    name)
                continue
            assert top == "numpy" or top in sys.stdlib_module_names, (
                rel, name)
            assert top not in ("torch", "benchmark"), (rel, name)


def test_guard_compares_whole_names():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "ntlink_tpu")
    import sys

    sys.modules["ntlink_tpu_torch_probe_x"] = sys
    try:
        assert harness.forbidden_modules() == []
        sys.modules["jaxlib.fake"] = sys
        assert harness.forbidden_modules() == ["jaxlib"]
    finally:
        sys.modules.pop("ntlink_tpu_torch_probe_x", None)
        sys.modules.pop("jaxlib.fake", None)
