"""Functional threefry2x32 keys, bit-exact with JAX's partitionable
threefry (``jax_threefry_partitionable=True``, the default of jax 0.9).

A key is a CPU ``int64`` tensor of shape ``(2,)`` holding two uint32
words; a batch of keys has shape ``(n, 2)``. Every function takes its key
explicitly, as ``jax.random`` does, so the estimator draws the same
numbers as the JAX package from the same seed. Keys are hashed on the
host in Python integers; on the CPU a draw emulates uint32 arithmetic in
int64 with masks (torch has no uint32 arithmetic), which is the plain
version of the card's draw: one launch of ``csrc/threefry.cu``
(``threefry_draw``) that gives the same bits.
"""

from __future__ import annotations

import math

import torch

from materialist_tpu_torch.ops.kernels import _lib
from materialist_tpu_torch.utils.profiling import (RNG_KEY_HASHES, RNG_VALUES,
                                                   count, span)

_M = 0xFFFFFFFF
_BITS = span("rng.bits")     # the hash of a draw's counts, on its device
_KEYS = span("rng.keys")     # split and fold_in: a few counts in Python ints
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _M) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of count pairs (x1, x2): int64
    tensors holding uint32 values, or Python ints in [0, 2³²)."""
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
    k1, k2 = k.tolist()
    return k1, k2


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys from counts (0, i), hashed in
    Python ints (a caller splits into at most 64)."""
    count(RNG_KEY_HASHES, num)
    with _KEYS:
        k1, k2 = _words(k)
        return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(num)],
                            dtype=torch.int64).reshape(num, 2)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count pair (0, data)."""
    count(RNG_KEY_HASHES, 1)
    with _KEYS:
        k1, k2 = _words(k)
        return torch.tensor(threefry2x32(k1, k2, 0, int(data) & _M),
                            dtype=torch.int64)


def bits_plain(k: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``bits`` in int64 torch on any device: the plain version."""
    k1, k2 = _words(k)
    cnt = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, cnt >> 32, cnt & _M)
    return (b1 ^ b2).reshape(shape)


def uniform_plain(k: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``uniform`` in [0, 1) from ``bits_plain``: the plain version."""
    b = bits_plain(k, shape, device)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0)


def lattice_plain(k: torch.Tensor, s: int, n_loc: int, gens,
                  device=None) -> torch.Tensor:
    """``lattice`` from ``uniform_plain``: the plain version."""
    g = torch.tensor(gens, dtype=torch.float32, device=device)
    t = torch.arange(s, dtype=torch.float32, device=device)[:, None, None]
    return torch.fmod(t * g + uniform_plain(k, (1, n_loc, len(gens)), device),
                      1.0)


def _draw(k: torch.Tensor, shape, device, mode: int,
          gens=()) -> torch.Tensor:
    """A draw of ``shape`` in the kernel's ``mode``: 0, int64 bits; 1,
    float32 uniforms in [0, 1); 2, the lattice (s, n_loc, len(gens)). On
    the CPU the plain version; on a CUDA card one launch of
    ``threefry_launch``."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"draws run on the CPU or a CUDA card, not on {dev}")
    shape = tuple(shape)
    n = math.prod(shape) if mode < 2 else math.prod(shape[1:])
    with _BITS:
        count(RNG_VALUES, n)
        if dev.type == "cpu":
            if mode == 2:
                return lattice_plain(k, shape[0], shape[1], gens, dev)
            return (bits_plain if mode == 0 else uniform_plain)(k, shape, dev)
        if not (torch.is_tensor(k) and k.dtype == torch.int64
                and tuple(k.shape) == (2,)):
            raise TypeError("a key is an int64 tensor of shape (2,)")
        k1, k2 = _words(k)
        s = shape[0] if mode == 2 else 1
        out = torch.empty(shape, device=dev,
                          dtype=torch.int64 if mode == 0 else torch.float32)
        if n and s:
            g0, g1 = (tuple(gens) + (0.0, 0.0))[:2]
            _lib.check(_lib.lib().threefry_launch(
                out.data_ptr(), mode, n, s, len(gens), k1, k2, g0, g1,
                _lib.stream_ptr(out)), "threefry_draw")
            _lib.count_launch("threefry_draw",
                              (n, s, out.element_size(), mode))
        return out


def bits(k: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32), row-major
    counts as ``iota_2x32_shape``; bits = hash₁ ⊕ hash₂."""
    return _draw(k, shape, device, 0)


def uniform(k: torch.Tensor, shape, device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, minval=minval, maxval=maxval)`` in
    float32: the 23 high bits as the mantissa of a float in [1, 2), minus
    1, then ``max(minval, f * (maxval - minval) + minval)`` with the
    product and sum fused into one rounding, as XLA's CPU backend
    contracts them (exact in float64: the product has 48 bits)."""
    f = _draw(k, shape, device, 1)
    if minval == 0.0 and maxval == 1.0:
        return f
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    out = (f.double() * span.double() + lo.double()).float()
    return torch.clamp_min(out, float(lo))


def lattice(k: torch.Tensor, s: int, n_loc: int, gens,
            device=None) -> torch.Tensor:
    """(s, n_loc, dims) float32, dims = len(gens), 1 or 2: the rank-1
    lattice t·g over the sample axis t, each element rotated by its
    u = ``uniform(k, (1, n_loc, dims))`` (Cranley-Patterson):
    fmod(t·g + u, 1), the generators rounded to float32, one rounding
    each for the product and the sum: what the JAX package's
    ``_lds_uniform`` gives on XLA's CPU backend, which leaves this
    multiply-add uncontracted (unlike ``uniform``'s bounds)."""
    if len(gens) not in (1, 2):
        raise ValueError(f"a lattice has 1 or 2 generators, not {len(gens)}")
    return _draw(k, (s, n_loc, len(gens)), device, 2, gens)


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
