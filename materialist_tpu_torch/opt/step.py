"""THE inverse-step implementation (counterpart of
``materialist_tpu/opt/step.py``): one code path for the loop and the CLI.

    plan   = plan_step(res, spp, device memory)
    recs   = for each group: trace(maps, key_g)            (no gradient)
    img    = mean_g mean_c shade(maps, recs_gc, key_gc)   (no graph)
    loss   = loss_of(maps, img)
    grads  = for each chunk: shade recomputed under autograd and
             back-propagated with ct_img / (G·C), plus the direct
             loss→maps cotangent, pulled back through maps_of

Recomputing one chunk's shade at a time under autograd is the port of
``jax.checkpoint`` + scan: only one chunk's graph is alive, which keeps
512²×64 spp inside device memory.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from materialist_tpu_torch import device as device_mod
from materialist_tpu_torch import rng
from materialist_tpu_torch.opt.plan import StepPlan, device_bytes, plan_step
from materialist_tpu_torch.render.scene import GBuffer, Materials
from materialist_tpu_torch.render.shader import (RenderConfig, _check_cfg,
                                                 _shade_chunk, n_chunks_of,
                                                 trace_step_records)
from materialist_tpu_torch.utils.profiling import span

_TRACE_ALL = span("phase.trace_all")
_STEP = span("phase.step")
_SHADE = span("phase.shade")        # the image: every chunk, no graph
_LOSS = span("phase.loss")          # the loss and its direct cotangents
_ADJOINT = span("phase.adjoint")    # each chunk again, under autograd
_PULLBACK = span("phase.pullback")  # maps' cotangents to the parameters
_SNAPSHOT = span("phase.snapshot")  # the parameters the loss saw
_UPDATE = span("phase.update")


class PhaseStep(NamedTuple):
    """Pieces of one optimization phase (env / material part).

    ``maps_of(params, extra) -> (Materials, envmap)`` is the phase's
    differentiable parameterization; ``loss_of((mats, env), img, extra)
    -> (loss, aux)``. ``params`` is an ``nn.Module`` or a dict of leaf
    tensors."""
    cfg: RenderConfig          # per-group render config (spp = spp/G)
    plan: StepPlan
    n_groups: int
    trace_all: Callable        # (params, extra, key) -> (records, keys)
    value_and_grad: Callable   # (params, extra, records) -> (loss, aux,
    #                            grads)
    make_step: Callable        # (optimizer) -> step


def param_list(params):
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return list(params.values())


def make_phase_step(cfg_full: RenderConfig, cam, gbuf: GBuffer,
                    maps_of: Callable, loss_of: Callable, *,
                    plan: StepPlan = None, device=None) -> PhaseStep:
    """Build the phase step on ``device`` (default: the card; raises
    without one unless ``device="cpu"``)."""
    dev = device_mod.resolve(device)
    _check_cfg(cfg_full)
    gbuf = GBuffer(*[t.to(dev) for t in gbuf])
    h, w = gbuf.dist.shape
    if plan is None:
        caps = cfg_full.compact_caps
        bounces = max(cfg_full.max_depth - 1, 1)
        # bounce 0 is uncompacted (fraction 1); bounces beyond len(caps)
        # reuse the last cap, as the shader does
        vert_frac = ((1.0 + sum(caps[min(i, len(caps) - 1)]
                                for i in range(bounces - 1))) / bounces
                     if caps else 1.0)
        plan = plan_step(max(h, w), cfg_full.spp,
                         hbm_bytes=device_bytes(dev),
                         max_chunk=cfg_full.chunk, bounces=bounces,
                         vert_frac=vert_frac)
    n_groups = max(min(plan.groups, cfg_full.spp), 1)
    spp_group = max(cfg_full.spp // n_groups, 1)
    cfg = cfg_full._replace(
        spp=spp_group,
        chunk=max(min(plan.chunk, cfg_full.chunk, spp_group), 1),
        replay_blob=plan.replay_blob and cfg_full.replay_blob)
    n_chunks = n_chunks_of(cfg)

    def trace_all(params, extra, key):
        with _TRACE_ALL:
            with torch.no_grad():
                mats, env = maps_of(params, extra)
            keys = rng.split(key, n_groups)
            recs = [trace_step_records(keys[g], cfg, cam, gbuf, mats, env)
                    for g in range(n_groups)]
            return recs, keys

    def value_and_grad(params, extra, records):
        recs, keys = records
        plist = param_list(params)
        for p in plist:
            p.grad = None
        mats, env = maps_of(params, extra)
        fields = list(mats) + [env]
        leaves = [f.detach().requires_grad_(f.requires_grad)
                  for f in fields]
        maps_l = (Materials(*leaves[:4]), leaves[4])

        def chunk_keys(g):
            return rng.split(keys[g], n_chunks)

        with _SHADE, torch.no_grad():
            img = None
            for g in range(n_groups):
                ck = chunk_keys(g)
                for c in range(n_chunks):
                    im = _shade_chunk(ck[c], recs[g][c], cfg, cam, gbuf,
                                      *maps_l)
                    img = im if img is None else img + im
            img = img / (n_chunks * n_groups)
        with _LOSS:
            img_leaf = img.detach().requires_grad_(True)
            loss, aux = loss_of(maps_l, img_leaf, extra)
            diff = [l for l in leaves if l.requires_grad]
            gs = torch.autograd.grad(loss, [img_leaf] + diff,
                                     allow_unused=True)
            ct_img = gs[0] / (n_chunks * n_groups)
            for leaf, g in zip(diff, gs[1:]):
                leaf.grad = torch.zeros_like(leaf) if g is None else g
        with _ADJOINT:
            for g in range(n_groups):
                ck = chunk_keys(g)
                for c in range(n_chunks):
                    out = _shade_chunk(ck[c], recs[g][c], cfg, cam, gbuf,
                                       *maps_l)
                    if out.requires_grad:
                        out.backward(ct_img)
        with _PULLBACK:
            pulled = [(f, leaf.grad) for f, leaf in zip(fields, leaves)
                      if f.requires_grad]
            if pulled:
                torch.autograd.backward([f for f, _ in pulled],
                                        [g for _, g in pulled])
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in plist]
        return loss.detach(), aux, grads

    def make_step(opt):
        """``step(params, opt_state, extra, records)`` updates ``params``
        in place and returns (loss, aux, params_pre): params_pre is a copy
        of the parameters the loss was computed with (SaveBest records
        it, not the updated ones)."""
        def step(params, opt_state, extra, records):
            with _STEP:
                loss, aux, grads = value_and_grad(params, extra, records)
                plist = param_list(params)
                with _SNAPSHOT:
                    if isinstance(params, torch.nn.Module):
                        pre = {k: v.detach().clone()
                               for k, v in params.state_dict().items()}
                    else:
                        pre = {k: v.detach().clone()
                               for k, v in params.items()}
                with _UPDATE:
                    opt.step(plist, grads, opt_state)
                return loss, aux, pre
        return step

    return PhaseStep(cfg=cfg, plan=plan, n_groups=n_groups,
                     trace_all=trace_all, value_and_grad=value_and_grad,
                     make_step=make_step)
