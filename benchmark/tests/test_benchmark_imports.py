"""Nothing under ``benchmark/`` imports JAX or the JAX package, compared
by whole top-level module name (``avsep_tpu_torch`` is the port)."""

import ast
import os

import pytest

from benchmark import harness

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.BENCH_DIR)
               for f in fs if f.endswith(".py"))


def _tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(f, harness.BENCH_DIR)
                              for f in FILES])
def test_no_jax_import(path):
    bad = set(_tops(path)) & set(harness.FORBIDDEN)
    assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert "avsep_tpu_torch" not in set(_tops(os.path.join(ref, f)))


def test_forbidden_loaded_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "avsep_tpu_torchish",
                        types.ModuleType("avsep_tpu_torchish"))
    assert "avsep_tpu" not in harness.forbidden_loaded()
