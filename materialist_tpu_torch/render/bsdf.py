"""Per-pixel BSDF closures for the G-buffer tracer (counterpart of
``materialist_tpu/render/bsdf.py``): ``disney``, the standard material,
and ``transparent``, the transparency edit. Material fetches are packed
into one (N, K) row per pixel (K = 8, or 15 with background, mask and
position for ``transparent``):

    gather(idx)                   -> blob (..., K)
    eval(blob, idx, wi, wo, n)    -> (brdf (..., 3), pdf (..., 1))
    sample(blob, idx, u1,u2,wo,n) -> (wi, pdf, weight)
    sample_dirs(blob, u1,u2,wo,n) -> wi (decision only)
    weight(f, pdf)                -> throughput weight of a lobe sample
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import math

import torch

from materialist_tpu_torch.camera import Camera, sqrt
from materialist_tpu_torch.ops import brdf as B
from materialist_tpu_torch.ops.kernels.rowops import (row_gather_diff,
                                                      row_scatter_add)
from materialist_tpu_torch.render.scene import Materials
from materialist_tpu_torch.utils import profiling as prof


class BSDF(NamedTuple):
    gather: Callable
    eval: Callable
    sample: Callable
    sample_dirs: Callable
    weight: Callable
    table: torch.Tensor = None       # packed (N, K) per-pixel table
    gather_reuse: Callable = None    # (idx, primal) → rows, free forward
    kind: str = "generic"            # "disney" may take the fused shade


PI = math.pi


class _ReuseGather(torch.autograd.Function):
    """Rows the trace pass already fetched: the forward returns them as
    they are, the backward scatter-adds the cotangent into the table
    (kernel C′). Slimmed replay rows carry 5 of the 8 channels, so the
    cotangent is zero-padded back to the table width first."""

    @staticmethod
    def forward(ctx, table, idx, primal):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.k = table.shape
        return primal.clone()

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        if cot.shape[-1] < ctx.k:
            cot = torch.nn.functional.pad(cot, (0, ctx.k - cot.shape[-1]))
        # bf16-rounded contributions: the JAX package's default adjoint
        g = row_scatter_add(cot.contiguous(), idx.to(torch.int32),
                            ctx.n_rows, exact=False)
        return g, None, None


def _pack(mats: Materials):
    n = mats.albedo.shape[0] * mats.albedo.shape[1]
    return prof.cat([mats.albedo.reshape(n, 3), mats.roughness.reshape(n, 1),
                     mats.metallic.reshape(n, 1), mats.normal.reshape(n, 3)],
                    dim=-1)


def _unpack(blob):
    return blob[..., 0:3], blob[..., 3:4], blob[..., 4:5], blob[..., 5:8]


def disney(mats: Materials) -> BSDF:
    """Standard material BSDF (MatDiffBSDF)."""
    table = _pack(mats)

    def reuse(idx, primal):
        return _ReuseGather.apply(table, idx, primal)

    def gather_fn(idx):
        # differentiable re-fetch: kernel C forward, C′ backward
        return row_gather_diff(table, idx)

    def eval_fn(blob, idx, wi, wo, normal):
        a, r, m, _ = _unpack(blob)
        return B.eval_brdf(wi, wo, normal, a, r, m)

    def sample_fn(blob, idx, u1, u2, wo, normal):
        a, r, m, _ = _unpack(blob)
        return B.sample_brdf(u1, u2, wo, normal, a, r, m)

    def sample_dirs_fn(blob, u1, u2, wo, normal):
        return B.sample_dirs(u1, u2, wo, normal, _unpack(blob)[1])

    def weight_fn(f, pdf):
        pdf_det = pdf.detach()
        w = torch.where(pdf_det > 1e-6, f / (pdf_det + 1e-6), 0.0)
        return torch.nan_to_num(w, nan=0.0, posinf=0.0, neginf=0.0)

    return BSDF(gather_fn, eval_fn, sample_fn, sample_dirs_fn, weight_fn,
                table, reuse, kind="disney")


def transparent(mats: Materials, bg, mask, spec_trans: float, ior: float,
                cam: Camera, positions,
                refract_distance: float = 1.0) -> BSDF:
    """Transparency-editing BSDF (TransBSDF). Inside ``mask``: Disney
    diffuse + metal lobe scaled by (1 - spec_trans) plus a glass lobe whose
    transmission fetches the background image ``bg`` at a doubly-refracted
    screen coordinate. Outside: the original BSDF.

    positions: (N, 3) world position of every pixel (for the refraction
    reprojection). refract_distance: 1.0, or 100 when the albedo colour is
    kept. The whole state is one (N, 15) table, [a3, r, m, n3, bg3, mask1,
    pos3], so a bounce fetches it by one row gather (kernel C)."""
    n = mats.albedo.shape[0] * mats.albedo.shape[1]
    bg_flat = bg.reshape(n, 3)
    table = prof.cat([_pack(mats), bg_flat,
                      mask.reshape(n, 1).to(torch.float32),
                      positions.reshape(n, 3)], dim=-1)
    h_img, w_img = mats.albedo.shape[0], mats.albedo.shape[1]

    def reuse(idx, primal):
        return _ReuseGather.apply(table, idx, primal)

    def gather_fn(idx):
        return row_gather_diff(table, idx)

    def refract_dir(wi, normal, eta_ratio: float):
        """Snell refraction; wi points away from the surface."""
        cos_i = B.dot(wi, normal)
        sin2_t = eta_ratio ** 2 * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
        cos_t = sqrt(torch.clamp(1.0 - sin2_t, 0.0, 1.0))
        return B.normalize(eta_ratio * (normal * cos_i - wi)
                           - normal * cos_t)

    def refracted_index(pos, wi, normal):
        """Double refraction → screen coordinate → flat pixel index."""
        d1 = refract_dir(wi, normal, 1.0 / ior)      # entering the medium
        p1 = pos + 0.3 * refract_distance * d1
        d2 = refract_dir(-d1, normal, ior)
        uv = cam.project(p1 + refract_distance * d2)
        ui = torch.clamp(torch.floor(uv[..., 0] + 0.5).to(torch.int32), 0,
                         w_img - 1)
        vi = torch.clamp(torch.floor(uv[..., 1] + 0.5).to(torch.int32), 0,
                         h_img - 1)
        return vi * w_img + ui

    def eval_fn(blob, idx, wi, wo, normal):
        alb, rough, metal, _ = _unpack(blob)
        in_mask = blob[..., 11:12] > 0.5
        pos = blob[..., 12:15]
        ridx = torch.where(in_mask[..., 0], refracted_index(pos, wo, normal),
                           idx.to(torch.int32))
        bg_col = bg_flat[ridx.long()]

        h = B.normalize(wi + wo)
        no_l = torch.clamp_min(B.dot(normal, wi), 0.0)
        no_v = torch.clamp_min(B.dot(normal, wo), 0.0)
        vo_h = torch.clamp_min(B.dot(wo, h), 0.0)
        no_h = torch.clamp_min(B.dot(normal, h), 0.0)
        lo_h = torch.clamp_min(B.dot(wi, h), 0.0)

        d = B.d_ggx(no_h, rough)
        pdf = 0.5 * d / (4 * torch.clamp_min(vo_h, 1e-4)) * no_h \
            + 0.5 * no_l / PI
        g = B.g_smith(no_v, no_l, rough)

        # the original Disney BRDF (outside the mask)
        base_d = alb * (1 - metal)
        f_d90 = 0.5 + 2 * (vo_h * vo_h) * rough
        f_out = 1 + (f_d90 - 1) * B.pow5(1 - no_v)
        f_in = 1 + (f_d90 - 1) * B.pow5(1 - no_l)
        brdf_ori = base_d / PI * f_out * f_in * no_l
        c0 = (1 - metal) * 0.04 + metal * alb
        f_m = c0 + (1 - c0) * B.pow5(1 - vo_h)
        brdf_ori = brdf_ori + d * g * f_m / 4 * no_l

        # the edited glass BSDF (inside the mask)
        kd = alb * (1 - metal) * (1 - spec_trans)
        base_glass = (1 - metal) * bg_col * spec_trans
        brdf_diff = kd / PI * no_l
        brdf_metal = d * g * f_m / 4.0 * no_l
        hw_in = 1.0 / (lo_h + 1e-6)
        hw_out = 1.0 / (vo_h + 1e-6)
        nw_in = 1.0 / (no_l + 1e-6)
        nw_out = 1.0 / (no_v + 1e-6)
        r_s = (hw_in - ior * hw_out) / (hw_in + ior * hw_out)
        r_p = (ior * hw_in - hw_out) / (ior * hw_in + hw_out)
        f_glass = 0.5 * (r_s * r_s + r_p * r_p)
        d_hack = B.d_ggx(no_h, torch.ones_like(rough))
        den = ior * hw_in + hw_out
        btdf = sqrt(torch.clamp_min(base_glass, 0.0)) * g * d_hack \
            * (1 - f_glass) * (ior ** 2 * hw_in * hw_out) \
            / (nw_in * nw_out * (den * den))
        brdf_spec_edit = base_glass * d * g / (4 * nw_in)
        f_glass_lobe = torch.where(no_l * no_v > 0, brdf_spec_edit, btdf)
        bsdf_edit = brdf_diff + brdf_metal + f_glass_lobe

        bsdf = torch.clamp_min(torch.where(in_mask, bsdf_edit, brdf_ori), 0.0)
        pdf = torch.clamp_min(pdf, 0.0)
        return torch.nan_to_num(bsdf), torch.nan_to_num(pdf)

    def sample_dirs_fn(blob, u1, u2, wo, normal):
        rough = _unpack(blob)[1]
        wi_d = B.sample_diffuse(u2, normal)
        wi_s = B.sample_ggx(u2, rough, wo, normal)
        return torch.where((u1 > 0.5)[..., None], wi_d, wi_s)

    def weight_fn(f, pdf):
        pdf = pdf.detach()
        return torch.nan_to_num(torch.where(pdf > 1e-6, f / (pdf + 1e-4),
                                            0.0))

    def sample_fn(blob, idx, u1, u2, wo, normal):
        wi = sample_dirs_fn(blob, u1, u2, wo, normal)
        f, pdf = eval_fn(blob, idx, wi, wo, normal)
        pdf = pdf.detach()
        return wi, pdf, weight_fn(f, pdf)

    return BSDF(gather_fn, eval_fn, sample_fn, sample_dirs_fn, weight_fn,
                table, reuse)
