"""Equirectangular environment-map lighting: lookup and CDF importance
sampling (counterpart of ``materialist_tpu/ops/envmap.py``).

Direction convention: u = frac(atan2(d.x, -d.z) / 2π) · W,
v = acos(d.y)/π · H, so dir(θ, φ) = (sinθ·sinφ, cosθ, -sinθ·cosφ).

Small emitters (H, W ≤ 64, the 16×32 optimized envmap) sample, evaluate
pdfs and fetch through the kernels of ``ops/kernels/envkernels.py``; the
bilinear fetch is differentiable through ``_LookupBilinearSmall``, whose
backward is the row scatter-add kernel. Large relighting emitters use a
flat CDF with binary search and plain gathers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from materialist_tpu_torch.ops.color import luminance
from materialist_tpu_torch.ops.kernels import envkernels as ek
from materialist_tpu_torch.ops.kernels.rowops import row_scatter_add
from materialist_tpu_torch.utils import profiling as prof

PI = math.pi
SMALL_ENV_AXIS = 64

dir_to_uv = ek.dir_to_uv
uv_to_dir = ek.uv_to_dir
bilinear_coords = ek.bilinear_coords


class EnvmapSampler(NamedTuple):
    envmap: torch.Tensor  # (H, W, 3) linear radiance
    c_cdf: torch.Tensor   # (H, W) conditional CDF along width
    m_cdf: torch.Tensor   # (H,)  marginal CDF over rows
    c_pdf: torch.Tensor   # (H, W) per-texel conditional mass
    m_pdf: torch.Tensor   # (H,)  per-row marginal mass


class FlatEnvmapSampler(NamedTuple):
    """Large-emitter sampler: one flat CDF over all H·W texels."""
    envmap: torch.Tensor  # (H, W, 3)
    cdf: torch.Tensor     # (H·W,) normalized inclusive CDF
    pmass: torch.Tensor   # (H, W) per-texel probability mass


def _is_small(h: int, w: int) -> bool:
    return h <= SMALL_ENV_AXIS and w <= SMALL_ENV_AXIS


class _LookupBilinearSmall(torch.autograd.Function):
    """Bilinear fetch from a small emitter: forward kernel E, backward the
    four weighted taps scatter-added into the emitter (kernel C′). No
    gradient flows to the tap coords (detached-sampling estimator)."""

    @staticmethod
    def forward(ctx, envmap, u0i, v0i, du, dv):
        ctx.save_for_backward(u0i, v0i, du, dv)
        ctx.env_shape = envmap.shape
        return ek.env_lookup_bilinear(envmap, u0i, v0i, du, dv)

    @staticmethod
    def backward(ctx, cot):
        u0i, v0i, du, dv = ctx.saved_tensors
        h, w, c = ctx.env_shape
        u1i = torch.remainder(u0i + 1, w)
        v1i = torch.clamp(v0i + 1, 0, h - 1)
        du = du[..., None]
        dv = dv[..., None]
        taps = ((v0i, u0i, (1 - du) * (1 - dv)), (v0i, u1i, du * (1 - dv)),
                (v1i, u0i, (1 - du) * dv), (v1i, u1i, du * dv))
        idx_all = prof.cat([(vi * w + ui).reshape(-1) for vi, ui, _ in taps])
        cot_all = prof.cat([(wt * cot).reshape(-1, c) for _, _, wt in taps])
        g = row_scatter_add(cot_all, idx_all.to(torch.int32), h * w,
                            exact=True)
        return g.reshape(h, w, c), None, None, None, None


def lookup_bilinear_at(envmap, u0i, v0i, du, dv):
    """Bilinear radiance fetch from precomputed tap coords."""
    h, w = envmap.shape[0], envmap.shape[1]
    if _is_small(h, w):
        return _LookupBilinearSmall.apply(
            envmap.contiguous(), u0i.to(torch.int32).contiguous(),
            v0i.to(torch.int32).contiguous(), du.contiguous(),
            dv.contiguous())
    flat = envmap.reshape(h * w, 3)
    u0 = u0i.long()
    v0 = v0i.long()
    u1 = torch.remainder(u0 + 1, w)
    v1 = torch.clamp(v0 + 1, 0, h - 1)
    du = du[..., None]
    dv = dv[..., None]
    top = flat[v0 * w + u0] * (1.0 - du) + flat[v0 * w + u1] * du
    bot = flat[v1 * w + u0] * (1.0 - du) + flat[v1 * w + u1] * du
    return top * (1.0 - dv) + bot * dv


def lookup_bilinear(envmap, d):
    """Bilinear radiance fetch along directions d (..., 3), φ-wrap /
    θ-clamp (Mitsuba emitter eval)."""
    h, w = envmap.shape[0], envmap.shape[1]
    return lookup_bilinear_at(envmap, *bilinear_coords(d, h, w))


def build_sampler(envmap):
    """Sin-weighted luminance CDFs; per-texel weights floored at 1% of the
    mean so no texel gets a ~0 pdf."""
    h, w = envmap.shape[0], envmap.shape[1]
    rows01 = (torch.arange(h, dtype=envmap.dtype, device=envmap.device)
              + 0.5) / h
    sin_theta = torch.sin(PI * rows01)[:, None]
    lum_sin = luminance(envmap) * sin_theta
    lum_sin = torch.maximum(lum_sin, 0.01 * torch.mean(lum_sin) + 1e-12)
    if not _is_small(h, w):
        cdf = torch.cumsum(lum_sin.reshape(-1), 0)
        total = cdf[-1]
        return FlatEnvmapSampler(envmap, cdf / total, lum_sin / total)
    c_sum = torch.cumsum(lum_sin, dim=1)
    row_tot = c_sum[:, -1:]
    m_sum = torch.cumsum(row_tot[:, 0], dim=0)
    total = m_sum[-1]
    return EnvmapSampler(envmap, (c_sum / row_tot).contiguous(),
                         (m_sum / total).contiguous(),
                         (lum_sin / row_tot).contiguous(),
                         (row_tot[:, 0] / total).contiguous())


def sample_dir(sampler, u2):
    """Decision half of ``sample``: (wi (..., 3), pdf (..., 1))."""
    if isinstance(sampler, FlatEnvmapSampler):
        wi, pdf, _ = _sample_flat(sampler, u2, False)
        return wi, pdf
    return ek.env_sample_dir(sampler.m_cdf, sampler.m_pdf, sampler.c_cdf,
                             sampler.c_pdf, u2.contiguous())


def sample(sampler, u2, with_radiance: bool = True):
    """Inverse-CDF envmap sample: (wi, pdf, radiance along wi or None)."""
    if isinstance(sampler, FlatEnvmapSampler):
        return _sample_flat(sampler, u2, with_radiance)
    wi, pdf = sample_dir(sampler, u2)
    rad = lookup_bilinear(sampler.envmap, wi) if with_radiance else None
    return wi, pdf, rad


def _sample_flat(sampler: FlatEnvmapSampler, u2, with_radiance: bool):
    env, cdf, pmass = sampler
    h, w = env.shape[0], env.shape[1]
    x0, x1 = u2[..., 0].contiguous(), u2[..., 1]
    i = torch.clamp(torch.searchsorted(cdf, x0, side="left"), 0, h * w - 1)
    at = cdf[i]
    prev = torch.where(i > 0, cdf[torch.clamp_min(i - 1, 0)], 0.0)
    du = torch.clamp((x0 - prev) / torch.clamp_min(at - prev, 1e-12), 0, 1)
    vi = i // w
    ui = i - vi * w
    u = ui.to(env.dtype) + du
    v = vi.to(env.dtype) + x1
    theta = v * PI / h
    wi = uv_to_dir(u, v, h, w).detach()
    sin_theta = torch.clamp_min(torch.sin(theta), 1e-6)
    pdf = ((h * w) * pmass.reshape(-1)[i]
           / (2.0 * PI * PI * sin_theta)).detach()
    rad = lookup_bilinear(env, wi) if with_radiance else None
    return wi, pdf[..., None], rad


def pdf_dir(sampler, d):
    """Density of ``sample`` at directions d (..., 3), for MIS weights."""
    if isinstance(sampler, EnvmapSampler):
        return ek.env_pdf_dir(sampler.m_pdf, sampler.c_pdf, d.contiguous())
    env = sampler.envmap
    h, w = env.shape[0], env.shape[1]
    u, v = dir_to_uv(d, h, w)
    ui = torch.clamp(u.to(torch.int32), 0, w - 1).long()
    vi = torch.clamp(v.to(torch.int32), 0, h - 1).long()
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    sin_theta = torch.clamp_min(torch.sin(theta), 1e-6)
    pm = sampler.pmass.reshape(-1)[vi * w + ui]
    return ((h * w) * pm / (2.0 * PI * PI * sin_theta))[..., None]


def rotate(envmap, angle_degrees: float):
    """Roll the envmap columns (the rolling relight)."""
    w = envmap.shape[1]
    shift = int(round(angle_degrees / 360.0 * w))
    return torch.roll(envmap, shift, dims=1)
