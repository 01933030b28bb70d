"""Shared set-up of the whole-slice step parity tests
(test_torch_step_env.py, test_torch_step_material.py and their compacted
twins in test_torch_compact_step.py): the 32² scene, Flax weights carried
to the port, one env and one "rm" phase step in each package, and the
record-flag and gradient bounds.

Bounds: >= 99.5% of record flags equal; image rtol/atol 2e-2 (the JAX CPU
sky fetch rounds its weights to bf16, envmap.py:174-180); loss within
5e-3 relative; the elementwise, mean-relative and signed-bias gradient
bounds of test_shadebounce.py."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.models import posmlp as jposmlp
from materialist_tpu.ops.color import linear_to_srgb as jsrgb
from materialist_tpu.ops.pallas import shadebounce as jsb
from materialist_tpu.opt.step import make_phase_step as jmake
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu.render.scene import make_gbuffer as jgbuf
from materialist_tpu.render.shader import RenderConfig as JCfg
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.models import posmlp as tposmlp
from materialist_tpu_torch.models.convert import (gbuffer_from_arrays,
                                                   materials_from_arrays,
                                                   posmlp_from_flax)
from materialist_tpu_torch.ops.color import linear_to_srgb as tsrgb
from materialist_tpu_torch.opt.step import make_phase_step as tmake
from materialist_tpu_torch.render.scene import Materials, make_gbuffer
from materialist_tpu_torch.render.shader import RenderConfig

RES = 32
CFG = dict(spp=4, chunk=2, max_depth=3, march_steps=6, shadow_steps=4,
           film_jitter=0.5)
ELEM_TOL = {"albedo": 3e-2, "roughness": 0.12, "metallic": 3e-2,
            "envmap": 3e-2}


def make_scene():
    r = np.random.default_rng(0)
    depth = (2.0 + 0.3 * r.uniform(size=(RES, RES))).astype(np.float32)
    depth[6:16, 8:22] -= 0.7
    depth[20:28, 3:12] -= 0.4
    gt = r.uniform(0.05, 0.6, (RES, RES, 3)).astype(np.float32)
    alb = r.uniform(0.2, 0.9, (RES, RES, 3)).astype(np.float32)
    rough = r.uniform(0.2, 0.9, (RES, RES, 1)).astype(np.float32)
    met = r.uniform(0.0, 0.5, (RES, RES, 1)).astype(np.float32)
    env = ((r.uniform(size=(16, 32, 3)) + 0.1) * 2).astype(np.float32)
    gj = jgbuf(jnp.asarray(depth), JCam(RES, RES), flip_depth=False)
    gt_ = make_gbuffer(depth, Camera(RES, RES), flip_depth=False)
    return dict(depth=depth, gt=gt, alb=alb, rough=rough, met=met, env=env,
                gj=gj, gt_buf=gt_, nrm=np.asarray(gj.normal_geo))


def flax_params(net, x, seed, head_std):
    p = jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(1),
                                          jnp.asarray(x))["params"])
    r = np.random.default_rng(seed)
    for k in ("kernel", "bias"):
        p["lin_out"][k] = r.normal(0, head_std, p["lin_out"][k].shape).astype(
            np.float32)
    return p


def run_jax(sc, maps_of, loss_of, params, extra, cfg=CFG):
    jsb._INTERPRET = True
    try:
        ph = jmake(JCfg(**cfg), JCam(RES, RES), sc["gj"], maps_of, loss_of)
        recs = ph.trace_all(params, extra, jax.random.PRNGKey(11))
        loss, aux, grads = ph.value_and_grad(params, extra, recs)
    finally:
        jsb._INTERPRET = False
    return recs, float(loss), aux, grads


def run_port(sc, maps_of, loss_of, params, extra, cfg=CFG):
    ph = tmake(RenderConfig(**cfg), Camera(RES, RES), sc["gt_buf"], maps_of,
               loss_of, device="cpu")
    recs = ph.trace_all(params, extra, rng.key(11))
    loss, aux, grads = ph.value_and_grad(params, extra, recs)
    return recs, float(loss), aux, grads


def check_records(recs_j, recs_t):
    flags = []
    for c, chunk in enumerate(recs_t[0][0]):
        for b, rec in enumerate(chunk):
            rj = recs_j[0][c][b]
            for i, got in ((0, rec.shadowed), (1, rec.hit), (2, rec.idx)):
                flags.append(np.asarray(rj[i])[0] == got.numpy())
    agree = float(np.mean(np.concatenate([f.reshape(-1) for f in flags])))
    assert agree >= 0.995, f"record flags agree {agree:.4f}"


def check_grad(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a, b, atol=ELEM_TOL[name] * scale,
                               err_msg=f"grad mismatch: {name}")
    mean_rel = np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12)
    assert mean_rel <= 5e-2, f"{name} mean rel {mean_rel:.3f}"
    bias = abs((a - b).mean()) / max(np.abs(b).mean(), 1e-12)
    assert bias <= 1e-2, f"{name} signed bias {bias:.4f}"


def torch_net(net, params):
    net.load_state_dict(posmlp_from_flax(params))
    return net


def env_phase_case(sc, **cfg_over):
    """One env-phase step in both packages (cfg_over: RenderConfig
    fields changed from CFG) with this module's bounds."""
    cfg = dict(CFG, **cfg_over)
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
    recs_j, loss_vj, img_j, g_j = run_jax(sc, maps_j, loss_j, pj, mats_j,
                                          cfg)

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

    recs_t, loss_vt, img_t, g_t = run_port(sc, maps_t, loss_t, pt, mats_t,
                                           cfg)
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
    return loss_vt, loss_vj


def material_phase_case(sc, **cfg_over):
    """One "rm" material-phase step in both packages (cfg_over:
    RenderConfig fields changed from CFG) with this module's bounds."""
    cfg = dict(CFG, **cfg_over)
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
                                           (cur_j, env_j), cfg)

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
        sc, maps_t, loss_t, pt, (cur_t, torch.from_numpy(sc["env"])), cfg)
    check_records(recs_j, recs_t)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=2e-2,
                               atol=2e-2)
    assert abs(loss_vt - loss_vj) <= 5e-3 * abs(loss_vj)
    names = list(pt)
    for key, name in (("d_a", "albedo"), ("d_r", "roughness"),
                      ("d_m", "metallic")):
        check_grad(name, g_t[names.index(key)].numpy(), g_j[key])
    return loss_vt, loss_vj


def _f32(x):
    """A record field of either package as a numpy array, with bf16 and
    f16 widened to float32."""
    if isinstance(x, torch.Tensor):
        return (x.to(torch.float32) if x.is_floating_point() else x).numpy()
    if jnp.issubdtype(x.dtype, jnp.floating):
        x = x.astype(jnp.float32)
    return np.asarray(x)


def check_records_equal(chunk_j, chunk_t):
    """One chunk's trace records, field by field: the JAX package's
    14-tuples against the port's BounceRecords (same field order, extras
    last). Flags, indices and the compaction extras (sel, count, vertex
    idx, film position) must be equal. bf16/f16 fields may differ where
    one package's f32 value rounds the other way: at least 99.5% of the
    elements equal, and all within two bf16 ulps (2^-6 relative, with
    1e-3 as the least magnitude)."""
    assert len(chunk_j) == len(chunk_t)
    for b, (rj, rt) in enumerate(zip(chunk_j, chunk_t)):
        assert len(rj) == len(rt._fields)
        for name, a, got in zip(rt._fields, rj, rt):
            where = f"bounce {b} {name}"
            if a is None or got is None:
                assert a is None and got is None, where
            elif name == "extras":
                assert len(a) == len(got) == 4, where
                for x, y in zip(a, got):
                    np.testing.assert_array_equal(y.numpy(), np.asarray(x),
                                                  err_msg=where)
            else:
                x, y = _f32(a), _f32(got)
                assert x.shape == y.shape, where
                if x.dtype.kind in "biu":
                    np.testing.assert_array_equal(y, x, err_msg=where)
                else:
                    assert np.mean(x == y) >= 0.995, where
                    np.testing.assert_array_less(
                        np.abs(x - y),
                        2.0 ** -6 * np.maximum(np.abs(x), 1e-3) + 1e-12,
                        err_msg=where)


def port_gbuffer(gj):
    """The JAX package's GBuffer carried to the port (CPU)."""
    return gbuffer_from_arrays(*(np.asarray(x) for x in gj))


def port_materials(mj):
    """The JAX package's Materials carried to the port (CPU)."""
    return materials_from_arrays(*(np.asarray(x) for x in mj))


@contextlib.contextmanager
def jax_fused_shade():
    """The JAX package's production shade on the CPU: its fused Pallas
    bounce in interpret mode (as its own tests run it), so that both
    packages replay the same packed records. Programs traced inside must
    not come from a jit cache filled outside: jit a fresh function."""
    jsb._INTERPRET = True
    try:
        yield
    finally:
        jsb._INTERPRET = False
