"""Wavefront compaction in the port's estimator against the JAX package
on the CPU: the same 32² scene (4 spp, max_depth 4, march steps 6/4, film
jitter 0.5, ``march_impl="fused"``) and the same key go through both
packages with the same ``compact_caps``; the JAX package takes its fused
shade in Pallas interpret mode.

Cases: caps (1.0, 1.0) and (0.5, 0.25) at chunk 2 (no live ray dropped,
fused shade), and caps (0.25, 0.125) at chunk 4 without NEE (the first
cap saturates, so live rays are dropped; generic shade).

Bounds: trace records as ``torch_step_common.check_records_equal`` states;
gradients within 2e-3 of their maximum and the image within rtol 1e-3 /
atol 1e-3 of its maximum with the fused shade (measured 2e-4; the
packages differ by the bf16 roundings of the records and by the order of
f32 sums); with the generic shade both also get rtol 2e-2, because the
JAX package's CPU fetch from a small emitter rounds its bilinear weights
to bf16 (envmap.py:174-180).
Inside the port, caps (1.0, 1.0) against no compaction keep
the JAX package's own limits (tests/test_compact.py): image rtol 1e-5 /
atol 1e-5, gradients 2e-3 of their maximum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.ops.pallas import shadebounce as jsb
from materialist_tpu.render import shader as jsh
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.render import shader as tsh
from materialist_tpu_torch.render.scene import Materials
from torch_step_common import CFG, RES, check_records_equal, make_scene

torch.set_num_threads(2)

CASES = {
    "caps_1_1": dict(compact_caps=(1.0, 1.0)),
    "caps_half_quarter": dict(compact_caps=(0.5, 0.25)),
    "caps_saturated_no_nee": dict(compact_caps=(0.25, 0.125), chunk=4,
                                  nee=False),
}


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _cfg(case):
    return dict(CFG, max_depth=4, **CASES[case])


def _port(sc, cfgd):
    cfg = tsh.RenderConfig(**cfgd)
    cam = Camera(RES, RES)
    alb = torch.from_numpy(sc["alb"]).requires_grad_()
    env = torch.from_numpy(sc["env"]).requires_grad_()
    mats = Materials(alb, torch.from_numpy(sc["rough"]),
                     torch.from_numpy(sc["met"]), sc["gt_buf"].normal_geo)
    recs = tsh.trace_step_records(rng.key(7), cfg, cam, sc["gt_buf"], mats,
                                  env)
    img = tsh.shade_from_records(rng.key(7), recs, cfg, cam, sc["gt_buf"],
                                 mats, env)
    torch.mean(img ** 2).backward()
    return recs, img.detach().numpy(), alb.grad.numpy(), env.grad.numpy()


@pytest.fixture(scope="module", params=list(CASES))
def both(request, scene):
    sc = scene
    cfgd = _cfg(request.param)
    cfg_j = jsh.RenderConfig(**cfgd)
    cam_j = JCam(RES, RES)
    rough, met = jnp.asarray(sc["rough"]), jnp.asarray(sc["met"])

    @jax.jit
    def run(key, alb, env):
        recs = jsh.trace_step_records(
            key, cfg_j, cam_j, sc["gj"],
            JMats(alb, rough, met, sc["gj"].normal_geo), env)

        def f(a, e):
            img = jsh.shade_from_records(
                key, recs, cfg_j, cam_j, sc["gj"],
                JMats(a, rough, met, sc["gj"].normal_geo), e)
            return jnp.mean(img ** 2), img
        (_, img), grads = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(alb, env)
        return recs, img, grads

    jsb._INTERPRET = True
    try:
        recs_j, img_j, (ga_j, ge_j) = run(jax.random.PRNGKey(7),
                                          jnp.asarray(sc["alb"]),
                                          jnp.asarray(sc["env"]))
    finally:
        jsb._INTERPRET = False
    return (cfgd, (recs_j, np.asarray(img_j), np.asarray(ga_j),
                   np.asarray(ge_j)), _port(sc, cfgd))


def test_trace_records_match_jax(both):
    cfgd, (recs_j, *_), (recs_t, *_) = both
    assert len(recs_j) == len(recs_t) == cfgd["spp"] // cfgd["chunk"]
    for chunk_j, chunk_t in zip(recs_j, recs_t):
        assert chunk_t[0].extras is None
        assert all(r.extras is not None for r in chunk_t[1:])
        check_records_equal(chunk_j, chunk_t)


def test_cap_utilization_matches_jax(both):
    cfgd, (recs_j, *_), (recs_t, *_) = both
    util_j = {}
    for b, f in jsh.compact_cap_utilization(recs_j):
        util_j[b] = max(util_j.get(b, 0.0), float(f))
    util_t = {b: float(f) for b, f in tsh.compact_cap_utilization(recs_t)}
    assert util_t == util_j and sorted(util_t) == [1, 2]
    saturated = cfgd["compact_caps"] == (0.25, 0.125)
    assert (util_t[1] >= 0.999) == saturated


def test_image_and_gradients_match_jax(both):
    cfgd, (_, img_j, ga_j, ge_j), (_, img_t, ga_t, ge_t) = both
    fused = cfgd.get("nee", True)
    assert np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, rtol=1e-3 if fused else 2e-2,
                               atol=1e-3 * np.abs(img_j).max())
    for got, ref in ((ga_t, ga_j), (ge_t, ge_j)):
        np.testing.assert_allclose(got, ref, rtol=1e-7 if fused else 2e-2,
                                   atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("nee", [True, False], ids=["fused", "generic"])
def test_compacted_matches_uncompacted_in_port(scene, nee):
    base = dict(CFG, max_depth=4, nee=nee)
    _, img0, ga0, ge0 = _port(scene, base)
    recs, img1, ga1, ge1 = _port(scene, dict(base, compact_caps=(1.0, 1.0)))
    assert recs[0][1].extras[0].shape == (2 * RES * RES,)
    np.testing.assert_allclose(img1, img0, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ga1, ga0, atol=2e-3 * np.abs(ga0).max())
    np.testing.assert_allclose(ge1, ge0, atol=2e-3 * np.abs(ge0).max())


def test_tight_caps_degrade_gracefully(scene):
    """Caps below the live count drop rays: the image stays finite and
    only dims slightly (the JAX package's own check and limit)."""
    base = dict(CFG, max_depth=4, chunk=4)
    _, img0, _, _ = _port(scene, base)
    _, img2, _, _ = _port(scene, dict(base, compact_caps=(0.25, 0.125)))
    assert np.isfinite(img2).all()
    assert np.abs(img2 - img0).mean() / (img0.mean() + 1e-9) < 0.2
    assert img2.sum() < img0.sum()


def test_probe_compact_caps_matches_jax(scene):
    sc = scene
    cfgd = dict(CFG, max_depth=4)
    caps_j = jsh.probe_compact_caps(
        jax.random.PRNGKey(5), jsh.RenderConfig(**cfgd), JCam(RES, RES),
        sc["gj"], JMats(jnp.asarray(sc["alb"]), jnp.asarray(sc["rough"]),
                        jnp.asarray(sc["met"]), sc["gj"].normal_geo),
        jnp.asarray(sc["env"]))
    caps_t = tsh.probe_compact_caps(
        rng.key(5), tsh.RenderConfig(**cfgd), Camera(RES, RES), sc["gt_buf"],
        Materials(torch.from_numpy(sc["alb"]), torch.from_numpy(sc["rough"]),
                  torch.from_numpy(sc["met"]), sc["gt_buf"].normal_geo),
        torch.from_numpy(sc["env"]))
    assert caps_t == caps_j
    assert len(caps_t) == 2 and all(0.0 < c <= 1.0 for c in caps_t)
