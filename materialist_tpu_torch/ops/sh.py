"""Real spherical harmonics for environment lighting (degree ≤ 4),
counterpart of ``materialist_tpu/ops/sh.py``: project an equirectangular
envmap onto real SH, reconstruct, rotate about the polar axis, and the
diffuse irradiance of SH lighting (Ramamoorthi-style), all closed-form
tensor code. An auxiliary lighting library: nothing in the package calls
it.

Conventions: θ polar from +y (the envmap's acos(d.y), matching
ops/envmap.py), φ = atan2(x, -z); real SH with Condon-Shortley-free
normalization K(l, m) = sqrt((2l+1)/(4π) · (l-|m|)!/(l+|m|)!).
"""

from __future__ import annotations

import math

import torch

from materialist_tpu_torch.camera import sqrt
from materialist_tpu_torch.ops import envmap as em


def num_coeffs(l_max: int) -> int:
    return (l_max + 1) ** 2


def _assoc_legendre(l_max: int, x):
    """P_l^m(x) for 0≤m≤l≤l_max via stable recurrences. Returns dict."""
    p = {(0, 0): torch.ones_like(x)}
    somx2 = sqrt(torch.clamp(1.0 - x * x, 0.0, 1.0))
    for m in range(1, l_max + 1):
        p[(m, m)] = (-1.0) ** m * _dfact(2 * m - 1) * somx2 ** m
    for m in range(0, l_max):
        p[(m + 1, m)] = x * (2 * m + 1) * p[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            p[(l, m)] = ((2 * l - 1) * x * p[(l - 1, m)]
                         - (l + m - 1) * p[(l - 2, m)]) / (l - m)
    return p


def _dfact(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def _k(l: int, m: int) -> float:
    return math.sqrt((2 * l + 1) / (4 * math.pi)
                     * math.factorial(l - abs(m))
                     / math.factorial(l + abs(m)))


def sh_basis(dirs, l_max: int = 4):
    """Real SH basis evaluated at unit directions (..., 3) → (..., n)."""
    theta_cos = torch.clamp(dirs[..., 1], -1.0, 1.0)       # cosθ = y
    phi = torch.atan2(dirs[..., 0], -dirs[..., 2])
    p = _assoc_legendre(l_max, theta_cos)
    cols = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            k = _k(l, m)
            if m == 0:
                cols.append(k * p[(l, 0)])
            elif m > 0:
                cols.append(math.sqrt(2.0) * k * torch.cos(m * phi)
                            * p[(l, m)])
            else:
                cols.append(math.sqrt(2.0) * k * torch.sin(-m * phi)
                            * p[(l, -m)])
    return torch.stack(cols, dim=-1)


def _texel_dirs(h: int, w: int, device):
    """Directions (h, w, 3) of the texel centres."""
    v = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    u = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return em.uv_to_dir(uu, vv, h, w)


def project_envmap(envmap, l_max: int = 4):
    """Envmap (H, W, 3) → SH coefficients (n, 3).

    c_lm = ∫ L(ω) Y_lm(ω) dω over the sphere (quadrature over texel
    centres with sinθ weights).
    """
    h, w = envmap.shape[0], envmap.shape[1]
    dirs = _texel_dirs(h, w, envmap.device)
    theta = math.pi * (torch.arange(h, dtype=torch.float32,
                                    device=envmap.device) + 0.5) / h
    d_omega = (torch.sin(theta)[:, None]
               * (math.pi / h) * (2 * math.pi / w))
    basis = sh_basis(dirs, l_max)                      # (h, w, n)
    return torch.einsum("hwn,hwc,hw->nc", basis, envmap, d_omega)


def reconstruct_envmap(coef, height: int, width: int, l_max: int = None,
                       clip: bool = True):
    """SH coefficients (n, 3) → envmap (H, W, 3)."""
    n = coef.shape[0]
    if l_max is None:
        l_max = int(math.isqrt(n)) - 1
    basis = sh_basis(_texel_dirs(height, width, coef.device), l_max)
    out = torch.einsum("hwn,nc->hwc", basis, coef)
    return torch.clamp_min(out, 0.0) if clip else out


def rotate_z(coef, angle_rad: float, l_max: int = None):
    """Rotate SH coefficients about the envmap's polar (y) axis — the SH
    analogue of envmap column rolling. Closed form: each (l, ±m) pair
    mixes by a 2×2 rotation of angle m·α."""
    n = coef.shape[0]
    if l_max is None:
        l_max = int(math.isqrt(n)) - 1
    out = [coef[0]]
    i = 1
    for l in range(1, l_max + 1):
        block = coef[i:i + 2 * l + 1]
        rotated = list(block)
        for m in range(1, l + 1):
            c, s = math.cos(m * angle_rad), math.sin(m * angle_rad)
            neg = block[l - m]   # Y_{l,-m}
            pos = block[l + m]   # Y_{l,+m}
            rotated[l - m] = c * neg + s * pos
            rotated[l + m] = -s * neg + c * pos
        out.extend(rotated)
        i += 2 * l + 1
    return torch.stack(out, dim=0)


# Lambertian irradiance convolution factors (Ramamoorthi & Hanrahan)
_A_HAT = [math.pi, 2.0 * math.pi / 3.0, math.pi / 4.0, 0.0,
          -math.pi / 24.0]


def irradiance(coef, normals, l_max: int = 2):
    """Diffuse irradiance E(n) from SH lighting — fast preview shading."""
    basis = sh_basis(normals, l_max)
    scale = torch.tensor([_A_HAT[l]
                          for l in range(l_max + 1)
                          for _ in range(2 * l + 1)], dtype=coef.dtype,
                         device=coef.device)
    return torch.einsum("...n,nc,n->...c", basis,
                      coef[: num_coeffs(l_max)], scale)
