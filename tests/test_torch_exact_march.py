"""The "exact" march of the port (``render/screenspace.py``: ``march``,
sequential and step-parallel, and ``occluded``) against the JAX package
on the CPU, on the seeded rays of tests/torch_march_rays.py, and a whole
render with ``march_impl="exact"``.

Bounds: hit flags equal on >= 99.9% of the rays (a step length that
differs in its last bit flips a silhouette ray), hit pixel equal and t
within 1e-4 where both hit; the 32x32 render within rtol/atol 2e-2 (the
JAX package takes its fused shade in Pallas interpret mode; its CPU sky
fetch rounds its bilinear weights to bf16, envmap.py:174-180)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.render import screenspace as jss
from materialist_tpu.render import shader as jsh
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.render import screenspace as tss
from materialist_tpu_torch.render import shader as tsh
from materialist_tpu_torch.render.scene import Materials
from materialist_tpu_torch.utils.seeded import (MARCH_CASES,
                                                march_case_inputs)
from torch_step_common import CFG, RES, jax_fused_shade, make_scene

torch.set_num_threads(2)


def _both(case, shadow_only, fn_j, fn_t, **kw):
    cam, tab, o, d, _, _ = march_case_inputs(case, shadow_only)
    jc = JCam(cam.height, cam.width)
    dist, valid = tab.dist.numpy(), tab.valid.numpy()
    out_j = fn_j(jc, jnp.asarray(dist), jnp.asarray(valid), jnp.asarray(o),
                 jnp.asarray(d), **kw)
    out_t = fn_t(cam, tab.dist, tab.valid, torch.from_numpy(o),
                 torch.from_numpy(d), **kw)
    return out_j, out_t


@pytest.mark.parametrize("vectorized", [False, True],
                         ids=["sequential", "vectorized"])
@pytest.mark.parametrize("case,shadow_only", MARCH_CASES,
                         ids=[c for c, _ in MARCH_CASES])
def test_march_matches_jax(case, shadow_only, vectorized):
    kw = dict(n_steps=24, n_refine=5, interval_frac=0.05,
              vectorized=vectorized)
    hj, ht = _both(case, shadow_only, jss.march, tss.march, **kw)
    hit_j, hit_t = np.asarray(hj.hit), ht.hit.numpy()
    assert np.mean(hit_j == hit_t) >= 0.999
    assert np.mean(np.asarray(hj.exited) == ht.exited.numpy()) >= 0.999
    both = hit_j & hit_t
    if case != "negative_pixels":
        assert both.sum() > 20, "the case should produce hits"
    assert ht.idx.dtype == torch.int32
    same_px = np.asarray(hj.idx)[both] == ht.idx.numpy()[both]
    assert same_px.sum() >= 0.999 * both.sum()
    np.testing.assert_allclose(ht.t.numpy()[both], np.asarray(hj.t)[both],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("interval_frac", [2.0, 0.05],
                         ids=["coarse_only", "two_refine_steps"])
@pytest.mark.parametrize("vectorized", [False, True],
                         ids=["sequential", "vectorized"])
def test_occluded_matches_jax(vectorized, interval_frac):
    kw = dict(n_steps=16, interval_frac=interval_frac, vectorized=vectorized)
    oj, ot = _both("frustum", False, jss.occluded, tss.occluded, **kw)
    oj = np.asarray(oj)
    assert ot.dtype == torch.bool
    assert 0.02 < oj.mean() < 0.98
    assert np.mean(oj == ot.numpy()) >= 0.999


def test_render_exact_matches_jax():
    sc = make_scene()
    cfgd = dict(CFG, march_impl="exact")
    mats_j = JMats(jnp.asarray(sc["alb"]), jnp.asarray(sc["rough"]),
                   jnp.asarray(sc["met"]), sc["gj"].normal_geo)
    with jax_fused_shade():
        img_j = jax.jit(lambda k: jsh.render_with_bsdf(
            k, jsh.RenderConfig(**cfgd), JCam(RES, RES), sc["gj"], mats_j,
            jnp.asarray(sc["env"])))(jax.random.PRNGKey(5))
    with torch.no_grad():
        img_t = tsh.render(rng.key(5), tsh.RenderConfig(**cfgd),
                           Camera(RES, RES), sc["gt_buf"],
                           Materials(torch.from_numpy(sc["alb"]),
                                     torch.from_numpy(sc["rough"]),
                                     torch.from_numpy(sc["met"]),
                                     sc["gt_buf"].normal_geo),
                           torch.from_numpy(sc["env"]))
    assert np.isfinite(img_t.numpy()).all()
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=2e-2,
                               atol=2e-2)
