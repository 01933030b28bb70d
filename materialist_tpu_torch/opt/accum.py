"""Exact gradient accumulation over sample groups with bounded memory
(counterpart of ``materialist_tpu/opt/accum.py``).

A step whose whole graph outgrows device memory (1024²×64 spp) splits
into groups, EXACTLY:

    recs_g    = trace(params, key_g)                    (no gradient)
    img       = mean_g shade(params, recs_g, key_g)     (no graph)
    loss, ct  = value_and_grad(loss_of_img)(img)
    grads     = Σ_g vjp(shade(·, recs_g, key_g), params)(ct / G)

The mean is linear, so pulling the image cotangent ct / G back through
each group gives the exact gradient of loss(mean image); only one
group's graph is alive at a time. ``params`` is a tree of tensors (dicts,
lists, tuples and NamedTuples such as ``Materials``); the gradient is
taken with respect to the tensors that require grad and is zero for the
others, and ``grads`` has the tree's structure. Nothing on the main path
calls this module: ``opt/step.py`` accumulates its groups itself.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from materialist_tpu_torch import rng


def _value_and_ct(loss_of_img: Callable, img):
    """(loss, d loss / d img) of a detached image."""
    img = img.detach().requires_grad_()
    loss = loss_of_img(img)
    (ct,) = torch.autograd.grad(loss, img)
    return loss.detach(), ct


def _vjp(fn: Callable, params, ct):
    """The gradient of <fn(params), ct> as a tree shaped like params."""
    leaves, spec = pytree.tree_flatten(params)
    diff = [i for i, x in enumerate(leaves) if x.requires_grad]
    gs = torch.autograd.grad(fn(params), [leaves[i] for i in diff],
                             grad_outputs=ct, allow_unused=True)
    out = [torch.zeros_like(x) for x in leaves]
    for i, g in zip(diff, gs):
        if g is not None:
            out[i] = g
    return pytree.tree_unflatten(out, spec)


def _add(a, b):
    return b if a is None else pytree.tree_map(torch.add, a, b)


def make_accum_value_and_grad_split(trace_fn: Callable, shade_fn: Callable,
                                    loss_of_img: Callable, n_groups: int,
                                    keep_records: bool = True):
    """Build value_and_grad(params, key, records=None) -> (loss, grads)
    for loss_of_img(mean render) over ``n_groups`` groups.

    trace_fn(params, key) -> records (run without gradient);
    shade_fn(params, records, key) -> (H, W, 3) image, differentiable in
    params; loss_of_img(img) -> scalar loss.

    With ``keep_records`` each group's records, traced once for the mean
    image, are reused by its backward and freed after it; without, they
    are dropped after the forward and traced again (for records that
    outgrow memory). ``value_and_grad.trace_all(params, key)`` traces
    every group once; passing its result as ``records=`` reuses it over
    several steps (the trace amortization of ``trace_every``).
    """
    def trace_all(params, key):
        keys = rng.split(key, n_groups)
        with torch.no_grad():
            return [trace_fn(params, keys[g]) for g in range(n_groups)], keys

    def value_and_grad(params, key, records=None):
        persistent = records is not None
        if persistent:
            recs, keys = records
        else:
            keys = rng.split(key, n_groups)
            recs = []
        img = None
        with torch.no_grad():
            for g in range(n_groups):
                if persistent:
                    r = recs[g]
                else:
                    r = trace_fn(params, keys[g])
                    if keep_records:
                        recs.append(r)
                im = shade_fn(params, r, keys[g])
                img = im if img is None else img + im
            img = img / n_groups
        loss, ct = _value_and_ct(loss_of_img, img)
        ct = ct / n_groups
        grads = None
        for g in range(n_groups):
            if persistent or keep_records:
                r = recs[g]
            else:
                with torch.no_grad():
                    r = trace_fn(params, keys[g])
            grads = _add(grads, _vjp(lambda p: shade_fn(p, r, keys[g]),
                                     params, ct))
            if keep_records and not persistent:
                recs[g] = None        # free this group's records
        return loss, grads

    value_and_grad.trace_all = trace_all
    return value_and_grad


def make_accum_value_and_grad_scan(trace_fn: Callable, shade_fn: Callable,
                                   loss_of_img: Callable, n_groups: int):
    """The JAX package's single-dispatch variant of
    :func:`make_accum_value_and_grad_split`: there, two ``lax.scan``s over
    the groups in one jit, with every group's records resident. PyTorch
    runs eagerly and has no dispatch to save, so here it is the split
    loop with the records kept: the same arithmetic, the same
    ``trace_all`` and ``records=`` route."""
    return make_accum_value_and_grad_split(trace_fn, shade_fn, loss_of_img,
                                           n_groups, keep_records=True)


def make_accum_value_and_grad(render_fn: Callable, loss_of_img: Callable,
                              n_groups: int):
    """Legacy interface: render_fn(params, key) -> image, rendered twice
    per group (once for the mean image, once under autograd for its
    vector-Jacobian product). Prefer make_accum_value_and_grad_split."""
    def value_and_grad(params, key):
        keys = rng.split(key, n_groups)
        img = None
        with torch.no_grad():
            for g in range(n_groups):
                im = render_fn(params, keys[g])
                img = im if img is None else img + im
            img = img / n_groups
        loss, ct = _value_and_ct(loss_of_img, img)
        ct = ct / n_groups
        grads = None
        for g in range(n_groups):
            grads = _add(grads, _vjp(lambda p: render_fn(p, keys[g]), params,
                                     ct))
        return loss, grads

    return value_and_grad
