"""Files of the benchmark found by name: a per-layer or end-to-end
metric's reader (``perfbench/metrics/<name>.py``) and a kernel's bound
(``perfbench/roofline/<launch counter>.py``). Names may hold dots, so the
files are loaded by path."""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))
_CACHE = {}


def load(kind: str, name: str):
    """The module of ``perfbench/<kind>/<name>.py``."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if path not in _CACHE:
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _CACHE[path] = mod
    return _CACHE[path]
