"""Whole-slice parity, envmap phase: one step of make_phase_step in both
packages from the same converted envmap PosMLP, the same keys and the
same 32² scene (4 spp, chunk 2, max_depth 3, march steps 6/4, film jitter
0.5); the JAX package takes its fused shade in Pallas interpret mode.
The envmap gradient is read through a zero offset added to the net's
output (its gradient is the map gradient). Bounds in
torch_step_common.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.models import posmlp as jposmlp
from materialist_tpu.ops.color import linear_to_srgb as jsrgb
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu_torch.models import posmlp as tposmlp
from materialist_tpu_torch.models.convert import posmlp_from_flax
from materialist_tpu_torch.ops.color import linear_to_srgb as tsrgb
from materialist_tpu_torch.render.scene import Materials
from torch_step_common import (check_grad, check_records, flax_params,
                               make_scene, run_jax, run_port, torch_net)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def test_env_phase_step(scene):
    sc = scene
    start = np.ones((512, 3), np.float32)
    net_j = jposmlp.make_envmap_net()
    p_np = flax_params(net_j, start, 1, head_std=0.05)
    gt_j = jsrgb(jnp.asarray(sc["gt"]))
    mats_j = JMats(jnp.asarray(sc["alb"]), jnp.asarray(sc["rough"]),
                   jnp.asarray(sc["met"]), sc["gj"].normal_geo)

    def maps_j(p, extra):
        env = net_j.apply({"params": p["net"]}, jnp.asarray(start))
        return extra, env.reshape(16, 32, 3) + p["delta"]

    def loss_j(maps, img, extra):
        pred = jsrgb(img)
        mse = jnp.mean((pred - gt_j) ** 2)
        return mse + jnp.mean(jnp.abs(pred - gt_j)), img

    pj = {"net": jax.tree.map(jnp.asarray, p_np),
          "delta": jnp.zeros((16, 32, 3))}
    recs_j, loss_vj, img_j, g_j = run_jax(sc, maps_j, loss_j, pj, mats_j)

    net_t = torch_net(tposmlp.make_envmap_net(), p_np)
    start_t = torch.from_numpy(start)
    gt_t = tsrgb(torch.from_numpy(sc["gt"]))
    mats_t = Materials(torch.from_numpy(sc["alb"]),
                       torch.from_numpy(sc["rough"]),
                       torch.from_numpy(sc["met"]), sc["gt_buf"].normal_geo)
    delta = torch.zeros((16, 32, 3), requires_grad=True)
    pt = dict(net_t.named_parameters())
    pt["delta"] = delta

    def maps_t(p, extra):
        return extra, net_t(start_t).reshape(16, 32, 3) + p["delta"]

    def loss_t(maps, img, extra):
        pred = tsrgb(img)
        mse = torch.mean((pred - gt_t) ** 2)
        return mse + torch.mean(torch.abs(pred - gt_t)), img.detach()

    recs_t, loss_vt, img_t, g_t = run_port(sc, maps_t, loss_t, pt, mats_t)
    check_records(recs_j, recs_t)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=2e-2,
                               atol=2e-2)
    assert abs(loss_vt - loss_vj) <= 5e-3 * abs(loss_vj)
    check_grad("envmap", g_t[-1].numpy(), g_j["delta"])
    # the net's own gradients are linear in the map gradient
    a = np.concatenate([g.numpy().ravel() for g in g_t[:-1]])
    wj = posmlp_from_flax(jax.tree.map(np.asarray, g_j["net"]))
    b = np.concatenate([wj[k].numpy().ravel()
                        for k, _ in net_t.named_parameters()])
    assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(b)
