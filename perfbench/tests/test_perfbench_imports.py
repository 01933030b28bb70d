"""By the syntax tree of every module under perfbench/: nothing imports
JAX, jaxlib, Flax or the JAX package (top-level names compared whole),
and nothing under perfbench/reference/ imports the program."""

from __future__ import annotations

import ast
import os

import pytest

from perfbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "materialist_tpu"}
HERE = os.path.join(ROOT, "perfbench")


def modules(sub=""):
    base = os.path.join(HERE, sub)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")
                       and d != "__pycache__"]
        for f in filenames:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    """Every module name that ``path`` imports, as written."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module)
    return out


def top_level_imports(path):
    return {name.split(".")[0] for name in imported(path)}


def test_modules_found():
    assert len(list(modules())) > 20


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(modules("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "materialist_tpu_torch" not in names
    assert names <= {"__future__", "math", "typing", "torch", "numpy",
                     "perfbench"}, names
    for name in imported(path):
        if name.split(".")[0] == "perfbench":
            assert name.startswith("perfbench.reference"), name


def test_whole_name_comparison():
    assert "materialist_tpu_torch".split(".")[0] not in FORBIDDEN
