"""Object insertion in the port (``geometry/raster.py``,
``render/glass.py``, ``render/insertion.py``, ``render_final --mode oi``)
against the JAX package on the CPU.

Bounds: the rasterizer is the same numpy code, so its layers are equal;
``refract`` / ``reflect`` / ``fresnel_dielectric`` 1e-6; ``shade_glass``
1e-4 at every pixel whose two background marches hit or miss alike in
both packages (at most 0.1% of the glass pixels may differ: a step length
that differs in its last bit flips a silhouette ray); the composited
G-buffer 1e-6."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.geometry import raster as jraster
from materialist_tpu.render import glass as jglass
from materialist_tpu.render import insertion as jins
from materialist_tpu.render.scene import make_gbuffer as jgbuf
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.geometry import raster as traster
from materialist_tpu_torch.render import glass as tglass
from materialist_tpu_torch.render import insertion as tins
from materialist_tpu_torch.utils.seeded import quad_mesh, sphere_mesh
from torch_scene_dirs import seeded_scene_dir
from torch_step_common import port_gbuffer

torch.set_num_threads(2)
F = np.float32
RES = 48
IOR = 1.49


@pytest.fixture(scope="module")
def scene():
    """A bumpy background with a nearer box, striped radiance, a sphere
    and a quad in front of it."""
    r = np.random.default_rng(11)
    depth = (3.0 + 0.2 * r.uniform(size=(RES, RES))).astype(F)
    depth[8:22, 28:44] -= 0.9
    gj = jgbuf(jnp.asarray(depth), JCam(RES, RES), flip_depth=False)
    stripes = (((np.arange(RES) + 3) // 6) % 2).astype(F)
    bg = np.broadcast_to(stripes[None, :, None], (RES, RES, 3)).copy()
    bg[..., 2] = 0.5
    # wider than 64 texels: both packages fetch the sky in float32 (the JAX
    # package's CPU fetch from a small emitter rounds to bf16)
    env = (r.uniform(size=(8, 80, 3)) + 0.1).astype(F)
    return dict(gj=gj, gt=port_gbuffer(gj), bg=bg, env=env,
                sphere=sphere_mesh([0.05, 0.0, -1.6], 0.35, 16, 32),
                quad=quad_mesh([-0.6, -0.5, -2.4], [0.5, 0.0, 0.2],
                               [0.0, 0.4, 0.2]))


@pytest.mark.parametrize("layer", ["front", "back"])
@pytest.mark.parametrize("mesh", ["sphere", "quad"])
def test_rasterize_equals_jax(scene, mesh, layer):
    v, f = scene[mesh]
    out_j = jraster.rasterize(v, f, JCam(RES, RES), layer=layer)
    out_t = traster.rasterize(v, f, Camera(RES, RES), layer=layer)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b)
    assert out_t[2].sum() > 20


def test_refract_reflect_fresnel_match_jax():
    r = np.random.default_rng(12)
    n = r.normal(size=(2000, 3)).astype(F)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = r.normal(size=(2000, 3)).astype(F)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.where(np.sum(d * n, -1, keepdims=True) > 0, -d, d).astype(F)
    for eta in (1.0 / IOR, IOR):
        t_j, tir_j = jglass.refract(jnp.asarray(d), jnp.asarray(n), eta)
        t_t, tir_t = tglass.refract(torch.from_numpy(d), torch.from_numpy(n),
                                    eta)
        np.testing.assert_array_equal(tir_t.numpy(), np.asarray(tir_j))
        np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-6)
        cos = np.linspace(0, 1, 501, dtype=F)
        np.testing.assert_allclose(
            tglass.fresnel_dielectric(torch.from_numpy(cos), eta).numpy(),
            np.asarray(jglass.fresnel_dielectric(jnp.asarray(cos), eta)),
            atol=1e-6)
    assert bool(tir_t.any()) and not bool(tir_t.all())   # glass → air
    np.testing.assert_allclose(
        tglass.reflect(torch.from_numpy(d), torch.from_numpy(n)).numpy(),
        np.asarray(jglass.reflect(jnp.asarray(d), jnp.asarray(n))),
        atol=1e-6)
    r0 = float(tglass.fresnel_dielectric(torch.tensor([1.0]), 1.0 / IOR)[0])
    assert abs(r0 - ((1 - IOR) / (1 + IOR)) ** 2) < 1e-6


def test_composite_gbuffer_matches_jax(scene):
    meshes = [scene["quad"], scene["sphere"]]
    gj, masks_j = jins.composite_gbuffer(scene["gj"], JCam(RES, RES), meshes)
    gt, masks_t = tins.composite_gbuffer(scene["gt"], Camera(RES, RES),
                                         meshes)
    for a, b in zip(masks_t, masks_j):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.sum() > 20
    for name, a, b in zip(gt._fields, gt, gj):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       err_msg=name)


def test_shade_glass_matches_jax(scene):
    v, f = scene["sphere"]
    cam_t = Camera(RES, RES)
    fd, fn, cover = traster.rasterize(v, f, cam_t, layer="front")
    bd, bn, _ = traster.rasterize(v, f, cam_t, layer="back")
    gj, gt = scene["gj"], scene["gt"]
    mask = cover & (fd < gt.dist.numpy())
    assert mask.sum() > 100
    out_j = np.asarray(jglass.shade_glass(
        JCam(RES, RES), gj.dist, gj.valid, jnp.asarray(scene["bg"]),
        jnp.asarray(scene["env"]), fd, fn, bd, bn, jnp.asarray(mask),
        ior=IOR))
    out_t = tglass.shade_glass(cam_t, gt.dist, gt.valid, scene["bg"],
                               scene["env"], fd, fn, bd, bn, mask,
                               ior=IOR).numpy()
    assert out_t.shape == (RES, RES, 3) and np.isfinite(out_t).all()
    assert np.array_equal(out_t[~mask], np.zeros_like(out_t[~mask]))
    close = np.all(np.abs(out_t - out_j) <= 1e-4, -1)
    assert close[mask].mean() >= 0.999, close[mask].mean()
    # the stripes show through the sphere, distorted: it is not flat
    assert out_t[mask].std() > 0.05


def test_render_final_oi_files(tmp_path):
    """--mode oi on a seeded 32x32 scene dir with oi.ply and oi2.ply: the
    file names of the JAX CLI, a finite image, both inserts visible."""
    from materialist_tpu_torch.cli import render_final
    from materialist_tpu_torch.io import image as image_io
    root = tmp_path / "in"
    seeded_scene_dir(root, "room", res=32, seed=5)
    out = str(tmp_path / "out")
    img = render_final.render_io("room", input_path=str(root), save_path=out,
                                 n_iter=1, spp=4, device="cpu")
    for ext in ("exr", "png"):
        assert os.path.exists(os.path.join(out, "room",
                                           f"mi_oi_room_envmap.{ext}"))
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    plain = render_final.render_real("room", input_path=str(root),
                                     save_path=out, n_iter=1, spp=4,
                                     device="cpu")
    cam = Camera(32, 32)
    for name in ("oi.ply", "oi2.ply"):
        from materialist_tpu_torch.geometry.ply import read_ply
        cover = traster.rasterize(*read_ply(str(root / "room" / name)),
                                  cam)[2]
        assert cover.sum() > 10, name
        assert np.abs(img[cover] - plain[cover]).mean() > 1e-2, name
    saved = image_io.read(os.path.join(out, "room", "mi_oi_room_envmap.exr"))
    np.testing.assert_allclose(saved[..., :3], img, atol=1e-6)


def test_render_insert_needs_a_mesh(tmp_path, scene):
    with pytest.raises(FileNotFoundError, match="oi.ply"):
        tins.render_insert(str(tmp_path), {}, scene["gt"], Camera(RES, RES),
                           scene["env"])
