"""The port's table lookups (plain versions of kernels F and G), its
single march (plain version of kernel A′, with ``shadow_only``) and the
two render paths they carry (``nee=False`` and ``march_impl="mip"``)
against the JAX package on the CPU, from numpy-seeded inputs.

Bounds: lookups equal (they are selections); march flags >= 99.9% equal
and t within 1e-4 where both hit the same pixel, as test_torch_march.py;
renders: hit/idx/shadowed records >= 99.9% equal, image and gradients
within rtol 2e-2 (the JAX package's CPU fetch from a small emitter rounds
its bilinear weights to bf16, envmap.py:174-180) plus 1e-3 and 2e-3 of
their maximum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.ops.pallas.gather import onehot_gather as j_onehot
from materialist_tpu.ops.pallas import shadebounce as jsb
from materialist_tpu.ops.pallas.march_kernel import march_fused as j_march
from materialist_tpu.ops.pallas.vreg_gather import vreg_gather as j_vreg
from materialist_tpu.render import shader as jsh
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu.render.scene import make_gbuffer as jmk
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.ops.kernels import march as mk
from materialist_tpu_torch.ops.kernels.gather import onehot_gather
from materialist_tpu_torch.ops.kernels.vreg_gather import vreg_gather
from materialist_tpu_torch.render import shader as tsh
from materialist_tpu_torch.render.scene import Materials, make_gbuffer
from test_torch_march import _scene
from torch_step_common import CFG, RES, make_scene

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("shape", [(16, 32), (128, 128), (8, 8, 3)])
def test_onehot_gather_matches_jax(shape):
    r = np.random.default_rng(shape[0])
    tab = r.normal(size=shape).astype(np.float32)
    idx = r.integers(0, shape[0] * shape[1], (3, 257)).astype(np.int32)
    got = onehot_gather(_t(tab), _t(idx))
    assert got.shape == idx.shape + shape[2:] and got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_onehot(jnp.asarray(tab), jnp.asarray(idx))))


@pytest.mark.parametrize("shape", [(32, 32), (128, 128), (256, 256)])
def test_vreg_gather_matches_jax(shape):
    r = np.random.default_rng(shape[0])
    tab = r.normal(size=shape).astype(np.float32)
    idx = r.integers(0, shape[0] * shape[1], (5, 300)).astype(np.int32)
    got = vreg_gather(_t(tab), _t(idx))
    assert got.shape == idx.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_vreg(jnp.asarray(tab), jnp.asarray(idx))))


def test_vreg_gather_rejects_large_tables():
    with pytest.raises(ValueError, match="H\\*W <= 65536"):
        vreg_gather(torch.zeros((512, 256)), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="H\\*W <= 65536"):
        vreg_gather(torch.zeros((8, 8, 3)), torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("shadow_only", [False, True],
                         ids=["full", "shadow_only"])
def test_march_single_matches_jax(shadow_only):
    res, s = 64, 2
    depth, mask = _scene(res, 2)
    gj = jmk(jnp.asarray(depth), JCam(res, res), flip_depth=False, mask=mask)
    gt = make_gbuffer(depth, Camera(res, res), flip_depth=False, mask=mask)
    r = np.random.default_rng(12)
    n = res * res
    nrm = np.asarray(gj.normal_geo).reshape(1, n, 3)
    v = r.normal(size=(s, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    d = np.where(np.sum(v * nrm, -1, keepdims=True) < 0, -v, v).astype(
        np.float32)
    origin = np.broadcast_to(np.asarray(gj.position).reshape(1, n, 3),
                             (s, n, 3)).astype(np.float32)
    kw = dict(n_steps=16, fine_steps=4, interval_frac=0.05,
              shadow_only=shadow_only)
    hj = j_march(JCam(res, res), gj.dist, gj.valid, jnp.asarray(origin),
                 jnp.asarray(d), **kw)
    ht = mk.march_single(Camera(res, res), mk.march_tables(gt.dist, gt.valid),
                         _t(origin), _t(d), **kw)
    for name, a, b in (("hit", hj.hit, ht.hit), ("idx", hj.idx, ht.idx),
                       ("exited", hj.exited, ht.exited)):
        agree = float(np.mean(np.asarray(a) == b.numpy()))
        assert agree >= 0.999, f"{name} agreement {agree:.5f}"
    both = np.asarray(hj.hit) & ht.hit.numpy() & (np.asarray(hj.idx)
                                                  == ht.idx.numpy())
    assert both.mean() > 0.05
    np.testing.assert_allclose(ht.t.numpy()[both], np.asarray(hj.t)[both],
                               atol=1e-4)
    if shadow_only:
        assert not ht.idx.any()


@pytest.fixture(scope="module")
def scene():
    return make_scene()


@pytest.mark.parametrize("over", [dict(nee=False), dict(march_impl="mip")],
                         ids=["nee_false", "march_impl_mip"])
def test_render_path_matches_jax(scene, over):
    sc = scene
    cfgd = dict(CFG, **over)
    cfg_j = jsh.RenderConfig(**cfgd)
    rough, met = jnp.asarray(sc["rough"]), jnp.asarray(sc["met"])

    @jax.jit
    def run(key, alb, env):
        recs = jsh.trace_step_records(
            key, cfg_j, JCam(RES, RES), sc["gj"],
            JMats(alb, rough, met, sc["gj"].normal_geo), env)

        def f(a, e):
            img = jsh.shade_from_records(
                key, recs, cfg_j, JCam(RES, RES), sc["gj"],
                JMats(a, rough, met, sc["gj"].normal_geo), e)
            return jnp.mean(img ** 2), img
        (_, img), grads = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(alb, env)
        return recs, img, grads

    jsb._INTERPRET = True      # the "mip" case takes the fused shade
    try:
        recs_j, img_j, (ga_j, ge_j) = run(jax.random.PRNGKey(9),
                                          jnp.asarray(sc["alb"]),
                                          jnp.asarray(sc["env"]))
    finally:
        jsb._INTERPRET = False
    cfg = tsh.RenderConfig(**cfgd)
    alb = torch.from_numpy(sc["alb"]).requires_grad_()
    env = torch.from_numpy(sc["env"]).requires_grad_()
    mats = Materials(alb, torch.from_numpy(sc["rough"]),
                     torch.from_numpy(sc["met"]), sc["gt_buf"].normal_geo)
    recs_t = tsh.trace_step_records(rng.key(9), cfg, Camera(RES, RES),
                                    sc["gt_buf"], mats, env)
    img_t = tsh.shade_from_records(rng.key(9), recs_t, cfg, Camera(RES, RES),
                                   sc["gt_buf"], mats, env)
    torch.mean(img_t ** 2).backward()
    flags = [np.asarray(rj[i]) == getattr(rt, f).numpy()
             for cj, ct in zip(recs_j, recs_t) for rj, rt in zip(cj, ct)
             for i, f in enumerate(("shadowed", "hit", "idx"))]
    agree = float(np.mean(np.concatenate([f.reshape(-1) for f in flags])))
    assert agree >= 0.999, f"record flags agree {agree:.5f}"
    assert any(bool(rt.hit.any()) for ct in recs_t for rt in ct)
    img_j = np.asarray(img_j)
    np.testing.assert_allclose(img_t.detach().numpy(), img_j, rtol=2e-2,
                               atol=1e-3 * np.abs(img_j).max())
    for got, ref in ((alb.grad, ga_j), (env.grad, ge_j)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2,
                                   atol=2e-3 * np.abs(ref).max())
