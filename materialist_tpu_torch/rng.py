"""Functional threefry2x32 keys, bit-exact with JAX's partitionable
threefry (``jax_threefry_partitionable=True``, the default of jax 0.9).

A key is a CPU ``int64`` tensor of shape ``(2,)`` holding two uint32
words; a batch of keys has shape ``(n, 2)``. Every function takes its key
explicitly, as ``jax.random`` does, so the estimator draws the same
numbers as the JAX package from the same seed. uint32 arithmetic is
emulated in int64 with masks (torch has no uint32 arithmetic).
"""

from __future__ import annotations

import math

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _M) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of count pairs (x1, x2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M
    y0 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + y0) & _M
            y0 = _rotl(y0, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        y0 = (y0 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, y0


def key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & M)."""
    return torch.tensor([(seed >> 32) & _M, seed & _M], dtype=torch.int64)


def _words(k: torch.Tensor):
    return int(k[0]), int(k[1])


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys from counts (0, i)."""
    k1, k2 = _words(k)
    cnt = torch.arange(num, dtype=torch.int64)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(cnt), cnt)
    return torch.stack([b1, b2], dim=-1)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count pair (0, data)."""
    k1, k2 = _words(k)
    d = torch.tensor([int(data) & _M], dtype=torch.int64)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.cat([b1, b2])


def bits(k: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32), row-major
    counts as ``iota_2x32_shape``; bits = hash₁ ⊕ hash₂."""
    k1, k2 = _words(k)
    n = math.prod(shape)
    cnt = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, cnt >> 32, cnt & _M)
    return (b1 ^ b2).reshape(shape)


def uniform(k: torch.Tensor, shape, device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, minval=minval, maxval=maxval)`` in
    float32: the 23 high bits as the mantissa of a float in [1, 2), minus
    1, then ``max(minval, f * (maxval - minval) + minval)`` with the
    product and sum fused into one rounding, as XLA's CPU backend
    contracts them (exact in float64: the product has 48 bits)."""
    b = bits(k, tuple(shape), device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return torch.clamp_min(f, 0.0)
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    out = (f.double() * span.double() + lo.double()).float()
    return torch.clamp_min(out, float(lo))


def _mul32(a, b):
    """(a · b) mod 2³² of uint32 values held in int64, in 16-bit halves
    so that no product leaves int64."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & _M


def randint(k: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32): two
    32-bit draws from ``split(k)`` combined as (hi mod span) · (2³² mod
    span) + (lo mod span), mod span, in uint32 arithmetic."""
    minval, maxval = int(minval), int(maxval)
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError("randint takes int32 bounds")
    k1, k2 = split(k)
    hi = bits(k1, tuple(shape), device)
    lo = bits(k2, tuple(shape), device)
    span = (maxval - minval) & _M if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & _M) % span     # uint32 product wraps
    off = (_mul32(hi % span, mult) + lo % span) & _M
    return (minval + off % span).to(torch.int32)


def bernoulli(k: torch.Tensor, p: float = 0.5, shape=(),
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` (float32 ``p``):
    ``uniform(k, shape) < p``."""
    return uniform(k, shape, device) < torch.tensor(p, dtype=torch.float32)
