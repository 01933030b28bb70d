"""Per-pixel BSDF closures for the G-buffer tracer (counterpart of
``materialist_tpu/render/bsdf.py``; the transparency BSDF is not ported
yet). Material fetches are packed into one (N, 8) row per pixel:

    gather(idx)                   -> blob (..., 8)
    eval(blob, idx, wi, wo, n)    -> (brdf (..., 3), pdf (..., 1))
    sample(blob, idx, u1,u2,wo,n) -> (wi, pdf, weight)
    sample_dirs(blob, u1,u2,wo,n) -> wi (decision only)
    weight(f, pdf)                -> throughput weight of a lobe sample
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from materialist_tpu_torch.ops import brdf as B
from materialist_tpu_torch.ops.kernels.rowops import (row_gather_diff,
                                                      row_scatter_add)
from materialist_tpu_torch.render.scene import Materials


class BSDF(NamedTuple):
    gather: Callable
    eval: Callable
    sample: Callable
    sample_dirs: Callable
    weight: Callable
    table: torch.Tensor = None       # packed (N, K) per-pixel table
    gather_reuse: Callable = None    # (idx, primal) → rows, free forward
    kind: str = "generic"            # "disney" may take the fused shade


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
    return torch.cat([mats.albedo.reshape(n, 3), mats.roughness.reshape(n, 1),
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
