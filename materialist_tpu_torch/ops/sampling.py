"""Stateless PRNG helpers for the Monte-Carlo estimator (counterpart of
``materialist_tpu/ops/sampling.py``), on the threefry keys of ``rng``."""

from __future__ import annotations

from materialist_tpu_torch import rng


def uniforms(key, shape, device=None):
    """U[0,1) of the given shape."""
    return rng.uniform(key, shape, device)
