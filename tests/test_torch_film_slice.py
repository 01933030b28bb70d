"""``FilmSlice`` renders of the port against the JAX package on the CPU:
the 32² scene of ``torch_step_common`` (4 spp in one chunk of 4,
max_depth 3, march steps 6/4, film jitter 0.5), rows 0, 8, 16 and 24 of
8 rows each, with and without compaction caps, from the same key. The
JAX package renders ``render_with_bsdf(..., film=FilmSlice(row0, 8))``
with its fused bounce in Pallas interpret mode, its slice's first row a
traced scalar (one program for the four slices).

Bounds: the step-parity bounds of ``torch_step_common``: the image
within rtol / atol 2e-2, the gradients of the albedo, roughness,
metallic and envmap by ``check_grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.render import shader as jsh
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.render import shader as tsh
from materialist_tpu_torch.render.scene import Materials
from torch_step_common import (CFG, RES, check_grad, jax_fused_shade,
                               make_scene)

torch.set_num_threads(2)

ROWS = 8
ROW0S = (0, 8, 16, 24)
CAPS = {"uncompacted": (), "compacted": (0.5,)}
SLICE_CFG = dict(CFG, chunk=4)
NAMES = ("albedo", "roughness", "metallic", "envmap")


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _jax_slices(sc, cfgd):
    cfg = jsh.RenderConfig(**cfgd)
    cam = JCam(RES, RES)

    @jax.jit
    def run(row0, alb, rough, met, env):
        def f(a, r, m, e):
            img = jsh.render_with_bsdf(
                jax.random.PRNGKey(7), cfg, cam, sc["gj"],
                JMats(a, r, m, sc["gj"].normal_geo), e,
                film=jsh.FilmSlice(row0=row0, n_rows=ROWS))
            return jnp.mean(img ** 2), img
        (_, img), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                             has_aux=True)(alb, rough, met,
                                                           env)
        return img, grads

    args = [jnp.asarray(sc[k]) for k in ("alb", "rough", "met", "env")]
    out = {}
    with jax_fused_shade():
        for row0 in ROW0S:
            img, grads = run(jnp.int32(row0), *args)
            out[row0] = (np.asarray(img), [np.asarray(g) for g in grads])
    return out


def _port_slice(sc, cfgd, row0):
    leaves = [torch.from_numpy(sc[k]).requires_grad_()
              for k in ("alb", "rough", "met", "env")]
    img = tsh.render_with_bsdf(
        rng.key(7), tsh.RenderConfig(**cfgd), Camera(RES, RES), sc["gt_buf"],
        Materials(*leaves[:3], sc["gt_buf"].normal_geo), leaves[3],
        film=tsh.FilmSlice(row0, ROWS))
    torch.mean(img ** 2).backward()
    return img.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.fixture(scope="module", params=list(CAPS))
def both(request, scene):
    cfgd = dict(SLICE_CFG, compact_caps=CAPS[request.param])
    return cfgd, _jax_slices(scene, cfgd), scene


@pytest.mark.parametrize("row0", ROW0S)
def test_film_slice_matches_jax(both, row0):
    cfgd, jax_out, sc = both
    img_j, grads_j = jax_out[row0]
    img_t, grads_t = _port_slice(sc, cfgd, row0)
    assert img_t.shape == img_j.shape == (ROWS, RES, 3)
    assert np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, rtol=2e-2, atol=2e-2)
    for name, got, ref in zip(NAMES, grads_t, grads_j):
        assert np.abs(ref).max() > 0, name
        check_grad(name, got, ref)


def test_film_slice_records_cover_its_rows(scene):
    """A slice's trace records have the slice's ray count, its primary
    vertices are its own pixels, and a slice outside the film raises."""
    sc = scene
    cfg = tsh.RenderConfig(**SLICE_CFG)
    mats = Materials(*[torch.from_numpy(sc[k])
                       for k in ("alb", "rough", "met")],
                     sc["gt_buf"].normal_geo)
    env = torch.from_numpy(sc["env"])
    recs = tsh.trace_step_records(rng.key(3), cfg, Camera(RES, RES),
                                  sc["gt_buf"], mats, env,
                                  film=tsh.FilmSlice(16, ROWS))
    assert len(recs) == 1
    assert recs[0][0].hit.shape == (cfg.chunk, ROWS * RES)
    img = tsh.shade_from_records(rng.key(3), recs, cfg, Camera(RES, RES),
                                 sc["gt_buf"], mats, env,
                                 film=tsh.FilmSlice(16, ROWS))
    assert img.shape == (ROWS, RES, 3)
    for bad in (tsh.FilmSlice(-1, ROWS), tsh.FilmSlice(30, ROWS),
                tsh.FilmSlice(0, 0)):
        with pytest.raises(ValueError, match="inside a film"):
            tsh.render_with_bsdf(rng.key(3), cfg, Camera(RES, RES),
                                 sc["gt_buf"], mats, env, film=bad)
