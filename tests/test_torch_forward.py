"""The forward path of the port against the JAX package on the CPU:
colour edits, envmap rotation, the denoiser, ``render_averaged``, the
relight and material-edit CLIs' file names, and the spherical harmonics.

Bounds (float32 elementwise code in both packages): HSV round trip,
``adj_albedo`` and ``apply_edits`` 1e-6, ``edit_flag`` strings equal,
``rotate`` exact, ``atrous_denoise`` (with and without its albedo and
normal maps) 1e-5, the SH functions 1e-5; the
averaged 32x32 render rtol/atol 2e-2 (the JAX package takes its fused
shade in Pallas interpret mode; its CPU sky fetch rounds its bilinear
weights to bf16, envmap.py:174-180)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.ops import color as jcolor
from materialist_tpu.ops import envmap as jem
from materialist_tpu.ops import sh as jsh
from materialist_tpu.render import denoise as jdn
from materialist_tpu.render import edits as jedits
from materialist_tpu.render import forward as jfwd
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.ops import color as tcolor
from materialist_tpu_torch.ops import envmap as tem
from materialist_tpu_torch.ops import sh as tsh
from materialist_tpu_torch.render import denoise as tdn
from materialist_tpu_torch.render import edits as tedits
from materialist_tpu_torch.render import forward as tfwd
from torch_scene_dirs import seeded_scene_dir
from torch_step_common import (RES, jax_fused_shade, make_scene,
                               port_materials)

torch.set_num_threads(2)
F = np.float32


def _rgb(seed, n=4000):
    r = np.random.default_rng(seed)
    x = r.uniform(size=(n, 3)).astype(F)
    x[:50] = x[:50, :1]                 # greys: delta == 0
    x[50:100, 1] = x[50:100, 0]         # ties of the two largest
    x[100:110] = 0.0
    return x


def test_hsv_matches_jax_and_round_trips():
    rgb = _rgb(0)
    hsv_j = np.asarray(jcolor.rgb_to_hsv(jnp.asarray(rgb)))
    hsv_t = tcolor.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(hsv_t.numpy(), hsv_j, atol=1e-6)
    back_j = np.asarray(jcolor.hsv_to_rgb(jnp.asarray(hsv_j)))
    back_t = tcolor.hsv_to_rgb(torch.from_numpy(hsv_j.copy())).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=1e-6)
    np.testing.assert_allclose(back_t, rgb, atol=1e-5)


def test_adj_albedo_matches_jax():
    alb = _rgb(1, 32 * 32).reshape(32, 32, 3) * 1.2 - 0.1   # clipped inside
    shift = np.array([[0.3, -0.2, 0.1]])
    a_j = np.asarray(jedits.adj_albedo(jnp.asarray(alb), shift))
    a_t = tedits.adj_albedo(torch.from_numpy(alb), shift).numpy()
    np.testing.assert_allclose(a_t, a_j, atol=1e-6)


@pytest.mark.parametrize("edit", [
    {"albedo": np.array([[0.25, 0.1, -0.05]]), "roughness": None,
     "metallic": None},
    {"albedo": None, "roughness": 0.35, "metallic": 1.0},
    {"albedo": np.array([[0.5, 0.0, 0.0]]), "roughness": 0.8,
     "metallic": None},
], ids=["hue", "rough_metal", "hue_rough"])
def test_apply_edits_matches_jax(edit):
    r = np.random.default_rng(2)
    mask = np.zeros((16, 16), bool)
    mask[4:12, 3:9] = True
    base = {"albedo": r.uniform(size=(16, 16, 3)).astype(F),
            "roughness": r.uniform(size=(16, 16, 1)).astype(F),
            "metallic": r.uniform(size=(16, 16, 1)).astype(F),
            "mask": mask}
    mat_j = {k: v.copy() for k, v in base.items()}
    mat_t = {k: v.copy() for k, v in base.items()}
    flag_j = jedits.apply_edits(mat_j, edit)
    flag_t = tedits.apply_edits(mat_t, edit)
    assert flag_t == flag_j and flag_t
    for k in ("albedo", "roughness", "metallic"):
        np.testing.assert_allclose(mat_t[k], mat_j[k], atol=1e-6, err_msg=k)
        assert np.array_equal(mat_t[k][~mask], base[k][~mask]), k


def test_apply_edits_needs_a_mask():
    with pytest.raises(FileNotFoundError, match="no mask"):
        tedits.apply_edits({"roughness": np.zeros((2, 2, 1))},
                           {"roughness": 0.5})


@pytest.mark.parametrize("angle", [0.0, 10.0, 95.0, 350.0, -40.0])
def test_rotate_matches_jax(angle):
    env = np.random.default_rng(3).uniform(size=(16, 32, 3)).astype(F)
    np.testing.assert_array_equal(
        tem.rotate(torch.from_numpy(env), angle).numpy(),
        np.asarray(jem.rotate(jnp.asarray(env), angle)))


@pytest.mark.parametrize("with_maps", [False, True],
                         ids=["colour_only", "albedo_normal_maps"])
def test_atrous_denoise_matches_jax(with_maps):
    r = np.random.default_rng(4)
    img = r.uniform(0, 2, (24, 20, 3)).astype(F)
    alb = (0.5 + 0.05 * r.uniform(size=(24, 20, 3))).astype(F)
    alb[:, 10:] += 0.3                                  # an albedo edge
    nrm = (np.array([0, 0, 1.0]) + 0.05 * r.normal(size=(24, 20, 3))).astype(F)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    kw_j = dict(albedo=jnp.asarray(alb), normal=jnp.asarray(nrm)) \
        if with_maps else {}
    kw_t = dict(albedo=torch.from_numpy(alb), normal=torch.from_numpy(nrm)) \
        if with_maps else {}
    out_j = np.asarray(jdn.atrous_denoise(jnp.asarray(img), **kw_j))
    out_t = tdn.atrous_denoise(torch.from_numpy(img), **kw_t).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    assert np.abs(out_t - img).mean() > 1e-3     # it does smooth


def test_render_averaged_matches_jax():
    sc = make_scene()
    mats_j = JMats(jnp.asarray(sc["alb"]), jnp.asarray(sc["rough"]),
                   jnp.asarray(sc["met"]), sc["gj"].normal_geo)
    kw = dict(n_iter=2, spp=4, denoise=True, seed=7)
    with jax_fused_shade():
        img_j = jfwd.render_averaged(sc["gj"], JCam(RES, RES), mats_j,
                                     sc["env"], **kw)
    img_t = tfwd.render_averaged(sc["gt_buf"], Camera(RES, RES),
                                 port_materials(mats_j), sc["env"], **kw)
    assert isinstance(img_t, np.ndarray) and img_t.shape == (RES, RES, 3)
    assert np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fwd_scene")
    seeded_scene_dir(root, "room", res=32, seed=5)
    seeded_scene_dir(root, "nook", res=16, seed=6)
    return str(root)


def test_render_final_real_and_mat_edit_files(scene_root, tmp_path):
    from materialist_tpu_torch.cli import mat_edit, render_final
    out = str(tmp_path)
    render_final.main(["--save_name", "room", "--mode", "real",
                       "--input_path", scene_root, "--save_path", out,
                       "--n_iter", "1", "--spp", "4", "--device", "cpu"])
    # no edit: the stem ends in the empty edit flag
    for ext in ("exr", "png"):
        assert os.path.exists(os.path.join(out, "room",
                                           f"mi_room_envmap_.{ext}"))
    mat_edit.main(["--save_name", "room", "--hue_shift", "0.3", "0.1", "0.0",
                   "--roughness", "0.4", "--input_path", scene_root,
                   "--save_path", out, "--n_iter", "1", "--spp", "4",
                   "--device", "cpu"])
    stem = "mi_room_envmap__a_0.3_r_0.4"
    from materialist_tpu_torch.io import image as image_io
    plain = image_io.read(os.path.join(out, "room", "mi_room_envmap_.exr"))
    edited = image_io.read(os.path.join(out, "room", f"{stem}.exr"))
    assert os.path.exists(os.path.join(out, "room", f"{stem}.png"))
    assert plain.shape == edited.shape == (32, 32, 3)
    assert np.isfinite(edited).all()
    # the edit changes the image inside the mask and leaves the far
    # corners (no light path through the mask at 4 spp dominates) finite
    assert np.abs(edited[8:24, 11:21] - plain[8:24, 11:21]).mean() > 1e-3


def test_render_final_rolling_files(scene_root, tmp_path):
    from materialist_tpu_torch.cli import render_final
    out = str(tmp_path)
    render_final.main(["--save_name", "nook", "--mode", "rolling",
                       "--input_path", scene_root, "--save_path", out,
                       "--frames", "2", "--rotation_step", "90",
                       "--device", "cpu"])
    d = os.path.join(out, "nook")
    for f in ("rolling_envmap_animation/frame_0000.png",
              "rolling_envmap_animation/frame_0001.png",
              "rolling_envmap_nook_envmap.gif"):
        assert os.path.exists(os.path.join(d, f)), f
    from materialist_tpu_torch.io import image as image_io
    f0 = image_io.read(os.path.join(d, "rolling_envmap_animation",
                                    "frame_0000.png"))
    f1 = image_io.read(os.path.join(d, "rolling_envmap_animation",
                                    "frame_0001.png"))
    assert np.abs(f0 - f1).mean() > 1e-3        # the light moved


def test_forward_entry_points_refuse_cpu_without_request(scene_root,
                                                         monkeypatch):
    from materialist_tpu_torch.cli import render_final, trans_edit
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: render_final.render_real("room",
                                                input_path=scene_root),
               lambda: render_final.render_rolling("room",
                                                   input_path=scene_root),
               lambda: render_final.render_io("room", input_path=scene_root),
               lambda: trans_edit.transparency_edit("room", 1.2, False, 0.4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


# ----------------------------------------------------- spherical harmonics

def _dirs(n=500):
    d = np.random.default_rng(6).normal(size=(n, 3)).astype(F)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("l_max", [2, 4])
def test_sh_basis_matches_jax(l_max):
    d = _dirs()
    np.testing.assert_allclose(
        tsh.sh_basis(torch.from_numpy(d), l_max).numpy(),
        np.asarray(jsh.sh_basis(jnp.asarray(d), l_max)), atol=1e-5)


def test_sh_project_reconstruct_rotate_irradiance_match_jax():
    env = np.random.default_rng(7).uniform(size=(16, 32, 3)).astype(F)
    c_j = jsh.project_envmap(jnp.asarray(env))
    c_t = tsh.project_envmap(torch.from_numpy(env))
    assert tuple(c_t.shape) == (tsh.num_coeffs(4), 3)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)
    c = np.asarray(c_j)
    for clip in (True, False):
        np.testing.assert_allclose(
            tsh.reconstruct_envmap(torch.from_numpy(c), 8, 16,
                                   clip=clip).numpy(),
            np.asarray(jsh.reconstruct_envmap(c_j, 8, 16, clip=clip)),
            atol=1e-5)
    np.testing.assert_allclose(
        tsh.rotate_z(torch.from_numpy(c), 0.7).numpy(),
        np.asarray(jsh.rotate_z(c_j, 0.7)), atol=1e-5)
    d = _dirs(200)
    np.testing.assert_allclose(
        tsh.irradiance(torch.from_numpy(c), torch.from_numpy(d)).numpy(),
        np.asarray(jsh.irradiance(c_j, jnp.asarray(d))), atol=1e-5)
