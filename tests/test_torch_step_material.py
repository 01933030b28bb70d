"""Whole-slice parity, "rm" material phase: one step of make_phase_step
in both packages from the same converted material PosMLP, the same keys
and the same 32² scene (4 spp, chunk 2, max_depth 3, march steps 6/4,
film jitter 0.5); the JAX package takes its fused shade in Pallas
interpret mode. Map gradients are read through zero offsets added to the
maps. Bounds in torch_step_common.py.

The net's head is perturbed only slightly, so roughness stays >= 0.13.
At the 0.07 floor the GGX denominator of a half-vector built from bf16/f16
records (NoH a hair above 1) cancels to ~0 in both packages
(brdf.py:68, shadebounce.py:82), and the gradient there is rounding
noise that neither package reproduces in the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.models import posmlp as jposmlp
from materialist_tpu.ops.color import linear_to_srgb as jsrgb
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu_torch.models import posmlp as tposmlp
from materialist_tpu_torch.ops.color import linear_to_srgb as tsrgb
from materialist_tpu_torch.render.scene import Materials
from torch_step_common import (RES, check_grad, check_records, flax_params,
                               make_scene, run_jax, run_port, torch_net)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def test_material_phase_step(scene):
    sc = scene
    n = RES * RES
    start = np.clip(np.concatenate([sc["alb"].reshape(n, 3),
                                    sc["rough"].reshape(n, 1),
                                    sc["met"].reshape(n, 1)], -1), 0, 1)
    net_j = jposmlp.make_brdf_net("arm")
    p_np = flax_params(net_j, start, 2, head_std=0.005)
    gt_lin = jnp.asarray(sc["gt"])
    gt_j = jsrgb(gt_lin)
    r_ori, m_ori = jnp.asarray(sc["rough"]), jnp.asarray(sc["met"])
    cur_j = {"albedo": jnp.asarray(sc["alb"]), "normal": sc["gj"].normal_geo}
    env_j = jnp.asarray(sc["env"])

    def maps_j(p, extra):
        cur, env = extra
        out = net_j.apply({"params": p["net"]}, jnp.asarray(start))
        rough = jnp.clip(out[..., 3:4] * 0.93 + 0.07, 0, 1).reshape(
            RES, RES, 1)
        metal = jnp.clip(out[..., 4:5], 0, 1).reshape(RES, RES, 1)
        return (JMats(jax.lax.stop_gradient(cur["albedo"]) + p["d_a"],
                      rough + p["d_r"], metal + p["d_m"],
                      jax.lax.stop_gradient(cur["normal"])), env)

    def loss_j(maps, img, extra):
        mats = maps[0]
        ratio = jnp.mean(gt_lin) / jnp.maximum(
            jax.lax.stop_gradient(jnp.mean(img)), 1e-9)
        pred = jsrgb(img * ratio)
        mse = jnp.mean((pred - gt_j) ** 2)
        l1 = jnp.mean(jnp.abs(pred - gt_j))
        aux = (jnp.mean(jnp.abs(mats.roughness - r_ori))
               + jnp.mean(jnp.abs(mats.metallic - m_ori)))
        sr = jax.lax.stop_gradient(l1 / jnp.maximum(mse, 1e-12))
        return 3.0 * sr * mse + l1 + aux * 0.1, img

    zeros = {"d_a": jnp.zeros((RES, RES, 3)), "d_r": jnp.zeros((RES, RES, 1)),
             "d_m": jnp.zeros((RES, RES, 1))}
    pj = {"net": jax.tree.map(jnp.asarray, p_np), **zeros}
    recs_j, loss_vj, img_j, g_j = run_jax(sc, maps_j, loss_j, pj,
                                           (cur_j, env_j))

    net_t = torch_net(tposmlp.make_brdf_net("arm"), p_np)
    start_t = torch.from_numpy(start)
    gt_lt = torch.from_numpy(sc["gt"])
    gt_t = tsrgb(gt_lt)
    rt_ori, mt_ori = torch.from_numpy(sc["rough"]), torch.from_numpy(
        sc["met"])
    cur_t = {"albedo": torch.from_numpy(sc["alb"]),
             "normal": sc["gt_buf"].normal_geo}
    pt = dict(net_t.named_parameters())
    for k, shp in (("d_a", 3), ("d_r", 1), ("d_m", 1)):
        pt[k] = torch.zeros((RES, RES, shp), requires_grad=True)

    def maps_t(p, extra):
        cur, env = extra
        out = net_t(start_t)
        rough = torch.clamp(out[..., 3:4] * 0.93 + 0.07, 0, 1).reshape(
            RES, RES, 1)
        metal = torch.clamp(out[..., 4:5], 0, 1).reshape(RES, RES, 1)
        return (Materials(cur["albedo"] + p["d_a"], rough + p["d_r"],
                          metal + p["d_m"], cur["normal"]), env)

    def loss_t(maps, img, extra):
        mats = maps[0]
        ratio = torch.mean(gt_lt) / torch.clamp_min(
            torch.mean(img).detach(), 1e-9)
        pred = tsrgb(img * ratio)
        mse = torch.mean((pred - gt_t) ** 2)
        l1 = torch.mean(torch.abs(pred - gt_t))
        aux = (torch.mean(torch.abs(mats.roughness - rt_ori))
               + torch.mean(torch.abs(mats.metallic - mt_ori)))
        sr = (l1 / torch.clamp_min(mse, 1e-12)).detach()
        return 3.0 * sr * mse + l1 + aux * 0.1, img.detach()

    recs_t, loss_vt, img_t, g_t = run_port(
        sc, maps_t, loss_t, pt, (cur_t, torch.from_numpy(sc["env"])))
    check_records(recs_j, recs_t)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=2e-2,
                               atol=2e-2)
    assert abs(loss_vt - loss_vj) <= 5e-3 * abs(loss_vj)
    names = list(pt)
    for key, name in (("d_a", "albedo"), ("d_r", "roughness"),
                      ("d_m", "metallic")):
        check_grad(name, g_t[names.index(key)].numpy(), g_j[key])
