"""Microfacet BRDF math (counterpart of ``materialist_tpu/ops/brdf.py``):
GGX NDF, Schlick-GGX Smith shadowing pre-divided by NoV·NoL, Disney
retro-reflective diffuse + GGX metal lobe with NoL folded in, and the
50/50 lobe mixture with pdf 0.5·D·NoH/(4 VoH) + 0.5·NoL/π.

Integer powers are written as products in the order XLA's
``integer_pow`` multiplies, so values agree with the JAX package to the
last bits wherever the inputs do.
"""

from __future__ import annotations

import math

import torch

from materialist_tpu_torch.camera import norm, sqrt

PI = math.pi


def pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def dot(a, b, keepdim: bool = True):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def normalize(v, eps: float = 1e-12):
    return v / torch.clamp_min(norm(v), eps)


def build_frame(n):
    """Branchless orthonormal frame (t, b, n) of normals (..., 3)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt, n


def to_world(local, n):
    t, b, nn = build_frame(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * nn


def d_ggx(no_h, roughness):
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    denom = no_h * no_h * (alpha2 - 1.0) + 1.0 + 1e-6
    return alpha2 / (PI * denom * denom)


def g1_ggx_schlick(no_x, roughness):
    r1 = roughness + 1.0
    k = r1 * r1 / 8.0
    return 1.0 / (no_x * (1.0 - k) + k + 1e-6)


def g_smith(no_v, no_l, roughness):
    return g1_ggx_schlick(no_l, roughness) * g1_ggx_schlick(no_v, roughness)


def eval_brdf(wi, wo, normal, albedo, roughness, metallic):
    """Disney-diffuse + GGX-metal BRDF (NoL folded in) and the mixture pdf.
    wi, wo, normal (..., 3); albedo (..., 3); roughness, metallic (..., 1)."""
    h = normalize(wi + wo)
    no_l = torch.clamp_min(dot(normal, wi), 0.0)
    no_v = torch.clamp_min(dot(normal, wo), 0.0)
    vo_h = torch.clamp_min(dot(wo, h), 0.0)
    no_h = torch.clamp_min(dot(normal, h), 0.0)

    d = d_ggx(no_h, roughness)
    pdf_spec = d / (4.0 * torch.clamp_min(vo_h, 1e-6)) * no_h
    pdf_diff = no_l / PI
    pdf = 0.5 * pdf_spec + 0.5 * pdf_diff

    base_d = albedo * (1.0 - metallic)
    f_d90 = 0.5 + 2.0 * (vo_h * vo_h) * roughness
    f_out = 1.0 + (f_d90 - 1.0) * pow5(1.0 - no_v)
    f_in = 1.0 + (f_d90 - 1.0) * pow5(1.0 - no_l)
    brdf_diff = base_d / PI * f_out * f_in * no_l

    g = g_smith(no_v, no_l, roughness)
    c0 = (1.0 - metallic) * 0.04 + metallic * albedo
    f_m = c0 + (1.0 - c0) * pow5(1.0 - vo_h)
    brdf_metal = d * g * f_m / 4.0 * no_l
    return brdf_diff + brdf_metal, pdf


def sample_diffuse(u2, normal):
    """Cosine-hemisphere sample; u2 (..., 2) → wi (..., 3) world."""
    sin_t = sqrt(torch.clamp(u2[..., 0], 0.0, 1.0))
    cos_t = sqrt(torch.clamp(1.0 - u2[..., 0], 0.0, 1.0))
    phi = 2.0 * PI * u2[..., 1]
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                         cos_t], dim=-1)
    return to_world(local, normal)


def sample_ggx(u2, roughness, wo, normal):
    """GGX half-vector sample reflected about wo, NaN-scrubbed."""
    alpha = (roughness * roughness)[..., 0]
    a2 = alpha * alpha
    cos_t = sqrt(torch.clamp(
        (1.0 - u2[..., 0]) / (u2[..., 0] * (a2 - 1.0) + 1.0), 0.0, 1.0))
    sin_t = sqrt(torch.clamp(1.0 - cos_t * cos_t, 0.0, 1.0))
    phi = 2.0 * PI * u2[..., 1]
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                         cos_t], dim=-1)
    wh = to_world(local, normal)
    wi = 2.0 * dot(wo, wh) * wh - wo
    return normalize(torch.nan_to_num(wi))


def sample_dirs(u1, u2, wo, normal, roughness):
    """50/50 lobe-mixture direction only (the trace pass's decision)."""
    wi_d = sample_diffuse(u2, normal)
    wi_s = sample_ggx(u2, roughness, wo, normal)
    return torch.where((u1 > 0.5)[..., None], wi_d, wi_s)


def sample_brdf(u1, u2, wo, normal, albedo, roughness, metallic):
    """(wi, pdf, weight) with weight = brdf/(pdf+1e-6), pdf detached."""
    wi = sample_dirs(u1, u2, wo, normal, roughness)
    brdf, pdf = eval_brdf(wi, wo, normal, albedo, roughness, metallic)
    pdf_det = pdf.detach()
    weight = torch.where(pdf_det > 1e-6, brdf / (pdf_det + 1e-6), 0.0)
    weight = torch.nan_to_num(weight, nan=0.0, posinf=0.0, neginf=0.0)
    return wi, pdf_det, weight
