"""Sharded render and train steps over ``torch.distributed`` (counterpart
of ``materialist_tpu/parallel/sharding.py``).

Every sharded path runs THE production estimator
(``render/shader.py::render_with_bsdf``), on two axes:

* sample ("spp") sharding: the unsharded render splits its key into
  n_chunks chunk keys; each rank takes a contiguous slice of those same
  keys, so the mean of the per-rank images is the unsharded image up to
  the order of the sums, and the all-reduced gradients are the unsharded
  gradients at the same total spp;
* film-row ("px") sharding: each rank renders a ``FilmSlice`` of the
  film; the G-buffer, material and march tables stay replicated (a
  secondary ray marches anywhere). Each rank's gradient carries its rows'
  contribution, and a SUM all-reduce assembles the full-film gradient.

No collective sits inside autograd: a rank differentiates its own
image, and the all-reduces act on detached tensors and on the gradients
afterwards. The train steps update the parameters in place through a
``torch.optim`` optimizer over the parameter tensors. Renders run
without a graph; the train steps hold one render's graph, as
``render_with_bsdf`` does.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.ops.color import linear_to_srgb
from materialist_tpu_torch.render.shader import (FilmSlice, RenderConfig,
                                                 n_chunks_of,
                                                 render_with_bsdf)


def _axis(mesh: DeviceMesh, axis: str):
    """(process group, size, this rank's index) of a mesh axis."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), mesh.get_local_rank(axis)


def _spp_share(cfg: RenderConfig, n_dev: int, i: int):
    """(local cfg, this rank's slice of the unsharded chunk keys)."""
    n_chunks = n_chunks_of(cfg)
    if n_chunks % n_dev:
        raise ValueError(f"spp // chunk = {n_chunks} is not a multiple of "
                         f"the {n_dev} devices of the axis")
    local = n_chunks // n_dev
    return (cfg._replace(spp=local * cfg.chunk),
            slice(i * local, (i + 1) * local))


def _film_share(h: int, n_dev: int, i: int) -> FilmSlice:
    """This rank's rows; as in the JAX package, the h % n_dev trailing
    rows of the film are not rendered."""
    n_rows = h // n_dev
    return FilmSlice(i * n_rows, n_rows)


def image_loss(img, gt_srgb):
    """MSE + L1 of the sRGB image against the target."""
    pred = linear_to_srgb(img)
    return torch.mean((pred - gt_srgb) ** 2) + torch.mean(
        torch.abs(pred - gt_srgb))


def _all_reduce_grads(optimizer, group) -> None:
    """SUM all-reduce of the gradient of every parameter the optimizer
    holds (zeros for a parameter the render did not reach)."""
    for pg in optimizer.param_groups:
        for p in pg["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            dist.all_reduce(p.grad, group=group)


def spp_sharded_render(mesh: DeviceMesh, cfg: RenderConfig, cam: Camera,
                       axis: str = "spp") -> Callable:
    """render(key, gbuf, mats, envmap) -> (h, w, 3) sharded over samples,
    the same image on every rank. Equals the unsharded render_with_bsdf
    at the same (key, cfg) up to the order of the sums: the union of the
    ranks' chunk keys is the unsharded chunk-key list."""
    group, n_dev, i = _axis(mesh, axis)
    local_cfg, share = _spp_share(cfg, n_dev, i)

    def render(key, gbuf, mats, envmap):
        keys = rng.split(key, n_chunks_of(cfg))[share]
        with torch.no_grad():
            img = render_with_bsdf(key, local_cfg, cam, gbuf, mats, envmap,
                                   keys=keys)
        dist.all_reduce(img, group=group)
        return img / n_dev

    return render


def px_sharded_render(mesh: DeviceMesh, cfg: RenderConfig, cam: Camera,
                      axis: str = "px") -> Callable:
    """render(key, gbuf, mats, envmap) -> (n_dev·(h // n_dev), w, 3) with
    the film's rows split across ranks: rank i renders FilmSlice(i·n_rows,
    n_rows) keyed by fold_in(key, i), and every rank returns all the rows.
    The rows are gathered by one SUM all-reduce of disjoint row blocks,
    which is exact and which gloo takes for CUDA tensors too."""
    group, n_dev, i = _axis(mesh, axis)

    def render(key, gbuf, mats, envmap):
        h, w = gbuf.dist.shape
        film = _film_share(h, n_dev, i)
        with torch.no_grad():
            rows = render_with_bsdf(rng.fold_in(key, i), cfg, cam, gbuf,
                                    mats, envmap, film=film)
        img = rows.new_zeros((n_dev * film.n_rows, w, 3))
        img[film.row0:film.row0 + film.n_rows] = rows
        dist.all_reduce(img, group=group)
        return img

    return render


def make_sharded_train_step(mesh: DeviceMesh, cfg: RenderConfig,
                            cam: Camera, optimizer,
                            axis: str = "spp") -> Callable:
    """Inverse step sharded over samples: step(params, key, gbuf, gt_srgb)
    -> loss, with params = {"mats": Materials, "envmap": (16, 32, 3)} the
    tensors ``optimizer`` updates, in place.

    Each rank renders its chunks; a detached copy, all-reduced, is the
    global mean image; the loss and its cotangent are taken on it, and
    the rank back-propagates its own image with the cotangent / n_dev.
    The SUM all-reduce of those gradients is then exactly the gradient of
    loss(mean image), the same on every rank, so the parameters and the
    optimizer state stay identical across ranks."""
    group, n_dev, i = _axis(mesh, axis)
    local_cfg, share = _spp_share(cfg, n_dev, i)

    def step(params, key, gbuf, gt_srgb):
        optimizer.zero_grad(set_to_none=True)
        keys = rng.split(key, n_chunks_of(cfg))[share]
        img = render_with_bsdf(key, local_cfg, cam, gbuf, params["mats"],
                               params["envmap"], keys=keys)
        mean = img.detach().clone()
        dist.all_reduce(mean, group=group)
        mean = (mean / n_dev).requires_grad_()
        loss = image_loss(mean, gt_srgb)
        (ct,) = torch.autograd.grad(loss, mean)
        img.backward(ct / n_dev)
        _all_reduce_grads(optimizer, group)
        optimizer.step()
        return loss.detach()

    return step


def make_px_sharded_train_step(mesh: DeviceMesh, cfg: RenderConfig,
                               cam: Camera, optimizer,
                               axis: str = "px") -> Callable:
    """Inverse step with the FILM sharded: each rank renders and
    back-propagates its own rows (the large-film case, where per-device
    ray state, records and scatter adjoints dominate memory). The loss is
    the global image MSE + L1 written as a sum of per-rank sums, so each
    rank's gradient is exactly its rows' contribution; SUM all-reduces of
    the loss and the gradients give the full-film values. Returns
    step(params, key, gbuf, gt_srgb) -> loss, updating params in place."""
    group, n_dev, i = _axis(mesh, axis)

    def step(params, key, gbuf, gt_srgb):
        h, w = gbuf.dist.shape
        film = _film_share(h, n_dev, i)
        gt_local = gt_srgb[film.row0:film.row0 + film.n_rows]
        optimizer.zero_grad(set_to_none=True)
        img = render_with_bsdf(rng.fold_in(key, i), cfg, cam, gbuf,
                               params["mats"], params["envmap"], film=film)
        diff = linear_to_srgb(img) - gt_local
        loss = (torch.sum(diff ** 2) + torch.sum(torch.abs(diff))) / (
            h * w * 3)
        loss.backward()
        loss = loss.detach()
        dist.all_reduce(loss, group=group)
        _all_reduce_grads(optimizer, group)
        optimizer.step()
        return loss

    return step
