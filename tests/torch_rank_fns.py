"""Rank functions of the port's tests, spawned by
``materialist_tpu_torch/parallel/dryrun.py::run_ranks`` (a spawned rank
imports this module, so it imports nothing of the JAX side)."""

import torch
import torch.distributed as dist

from materialist_tpu_torch import rng
from materialist_tpu_torch.parallel.dryrun import (identical_across_ranks,
                                                   leaves, optimizer_state,
                                                   scene_on)
from materialist_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from materialist_tpu_torch.parallel.sharding import (
    make_px_sharded_train_step, make_sharded_train_step, px_sharded_render)
from materialist_tpu_torch.render.shader import RenderConfig


def mesh_2d_coords(dev, n_px, n_spp):
    """(rank, px index, spp index, px size, spp size) on a 2-D mesh."""
    mesh = make_mesh_2d(n_px, n_spp, dev.type)
    return (dist.get_rank(), mesh.get_local_rank("px"),
            mesh.get_local_rank("spp"),
            dist.get_world_size(mesh.get_group("px")),
            dist.get_world_size(mesh.get_group("spp")))


def px_render_rank(dev, scene: dict, cfg_fields: dict, seed: int):
    """The px-sharded render of the scene's maps keyed by ``seed``: the
    gathered image (numpy) as this rank holds it."""
    cam, gbuf, params, _ = scene_on(scene, dev)
    mesh = make_mesh(dist.get_world_size(), "px", dev.type)
    with torch.no_grad():
        img = px_sharded_render(mesh, RenderConfig(**cfg_fields), cam)(
            rng.key(seed), gbuf, params["mats"], params["envmap"])
    return img.cpu().numpy()


def train_step_rank(dev, scene: dict, cfg_fields: dict, axis: str = "spp",
                    lr: float = 1e-2, seed: int = 1):
    """One spp- or px-sharded step with Adam(lr, eps 1e-8) from the
    scene's maps, keyed by ``seed``. Returns this rank's loss, parameters,
    all-reduced gradients and optimizer state (numpy), and whether those
    are the same bit for bit on every rank."""
    cfg = RenderConfig(**cfg_fields)
    cam, gbuf, params, gt = scene_on(scene, dev)
    opt = torch.optim.Adam(leaves(params), lr=lr, eps=1e-8)
    make = (make_sharded_train_step if axis == "spp"
            else make_px_sharded_train_step)
    mesh = make_mesh(dist.get_world_size(), axis, dev.type)
    loss = make(mesh, cfg, cam, opt, axis=axis)(params, rng.key(seed), gbuf,
                                                gt)
    state = optimizer_state(opt)

    def host(ts):
        return [t.detach().cpu().numpy() for t in ts]
    return {"loss": float(loss), "params": host(leaves(params)),
            "grads": host(t.grad for t in leaves(params)),
            "state": host(state),
            "identical": identical_across_ranks(leaves(params) + state)}
