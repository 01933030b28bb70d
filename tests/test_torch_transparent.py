"""The transparency edit of the port (``render/bsdf.py::transparent``,
``cli/trans_edit.py``) against the JAX package on the CPU.

Bounds: ``eval`` / ``sample`` / ``sample_dirs`` / ``weight`` on seeded
blobs within rtol 1e-5 (atol 1e-5 of the largest value) on >= 99.9% of the
queries and within rtol 1e-3 on all of them but the few whose refracted
fetch lands on another background texel: the GGX denominator
no_h²(α² − 1) + 1 cancels at low roughness and multiplies a last-bit
difference of a dot product, and a projection within float32 rounding of
a pixel border may round the other way; a
32x32 render within rtol/atol 2e-2 (generic shade in both packages; the
JAX package's CPU fetch from a small emitter rounds its bilinear weights
to bf16, envmap.py:174-180); the port's CLI at 64x64 meets the committed
golden of the JAX package's CLI (tests/golden/trans_edit_64.png) at that
test's own threshold, PSNR > 30 dB, and writes its file names."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.render import bsdf as jbsdf
from materialist_tpu.render import shader as jshader
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu_torch import config as tconfig
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.io import image as image_io
from materialist_tpu_torch.render import bsdf as tbsdf
from materialist_tpu_torch.render import shader as tshader
from torch_scene_dirs import trans_golden_scene_dir
from torch_step_common import CFG, RES, make_scene, port_materials

torch.set_num_threads(2)
F = np.float32
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "trans_edit_64.png")


@pytest.fixture(scope="module")
def closures():
    """The two packages' transparent BSDFs over one seeded 32x32 scene."""
    sc = make_scene()
    r = np.random.default_rng(8)
    bg = r.uniform(0.05, 0.9, (RES, RES, 3)).astype(F)
    mask = np.zeros((RES, RES), bool)
    mask[8:24, 6:26] = True
    mats_j = JMats(jnp.asarray(sc["alb"]), jnp.asarray(sc["rough"]),
                   jnp.asarray(sc["met"]), sc["gj"].normal_geo)
    n = RES * RES
    bj = jbsdf.transparent(mats_j, jnp.asarray(bg), jnp.asarray(mask), 0.4,
                           1.2, JCam(RES, RES),
                           sc["gj"].position.reshape(n, 3))
    bt = tbsdf.transparent(port_materials(mats_j), torch.from_numpy(bg),
                           torch.from_numpy(mask), 0.4, 1.2,
                           Camera(RES, RES),
                           sc["gt_buf"].position.reshape(n, 3))
    return sc, mats_j, bj, bt


def _queries(sc, n_q=3000):
    r = np.random.default_rng(9)
    idx = r.integers(0, RES * RES, n_q).astype(np.int32)
    nrm = np.asarray(sc["gj"].normal_geo).reshape(-1, 3)[idx]

    def hemi():
        v = r.normal(size=(n_q, 3)).astype(F)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        return np.where(np.sum(v * nrm, -1, keepdims=True) < 0, -v, v)
    wi = hemi()
    wi[: n_q // 4] *= -1        # a quarter below the surface: the btdf side
    return (idx, wi.astype(F), hemi().astype(F), nrm.astype(F),
            r.uniform(size=n_q).astype(F), r.uniform(size=(n_q, 2)).astype(F))


def _close(a, b, what, all_rows=True):
    a, b = a.numpy().reshape(len(a), -1), np.asarray(b).reshape(len(a), -1)
    scale = max(np.abs(b).max(), 1.0)
    err = np.abs(a - b)
    tight = np.all(err <= 1e-5 * np.abs(b) + 1e-5 * scale, -1)
    assert tight.mean() >= 0.999, (what, tight.mean())
    if all_rows:
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=what)


def test_table_and_gather(closures):
    sc, _, bj, bt = closures
    assert tuple(bt.table.shape) == (RES * RES, 15) and bt.kind == "generic"
    np.testing.assert_array_equal(bt.table.numpy(), np.asarray(bj.table))
    idx = _queries(sc)[0]
    np.testing.assert_array_equal(bt.gather(torch.from_numpy(idx)).numpy(),
                                  np.asarray(bj.gather(jnp.asarray(idx))))


def test_eval_matches_jax(closures):
    sc, _, bj, bt = closures
    idx, wi, wo, nrm, _, _ = _queries(sc)
    blob_j = bj.gather(jnp.asarray(idx))
    f_j, p_j = bj.eval(blob_j, jnp.asarray(idx), jnp.asarray(wi),
                       jnp.asarray(wo), jnp.asarray(nrm))
    it = torch.from_numpy(idx)
    f_t, p_t = bt.eval(bt.gather(it), it, torch.from_numpy(wi),
                       torch.from_numpy(wo), torch.from_numpy(nrm))
    _close(f_t, f_j, "bsdf", all_rows=False)
    _close(p_t, p_j, "pdf")
    assert np.isfinite(f_t.numpy()).all() and (f_t.numpy() >= 0).all()
    inside = np.asarray(bj.table)[idx, 11] > 0.5
    assert inside.sum() > 500 and (~inside).sum() > 500


def test_sample_matches_jax(closures):
    sc, _, bj, bt = closures
    idx, _, wo, nrm, u1, u2 = _queries(sc)
    blob_j = bj.gather(jnp.asarray(idx))
    wi_j, p_j, w_j = bj.sample(blob_j, jnp.asarray(idx), jnp.asarray(u1),
                               jnp.asarray(u2), jnp.asarray(wo),
                               jnp.asarray(nrm))
    it = torch.from_numpy(idx)
    blob_t = bt.gather(it)
    args = (torch.from_numpy(u1), torch.from_numpy(u2), torch.from_numpy(wo),
            torch.from_numpy(nrm))
    wi_t, p_t, w_t = bt.sample(blob_t, it, *args)
    _close(wi_t, wi_j, "wi")
    _close(bt.sample_dirs(blob_t, *args), wi_j, "sample_dirs")
    _close(p_t, p_j, "pdf")
    _close(w_t, w_j, "weight", all_rows=False)
    assert not p_t.requires_grad


def test_weight_matches_jax(closures):
    _, _, bj, bt = closures
    r = np.random.default_rng(10)
    f = r.uniform(0, 3, (500, 3)).astype(F)
    pdf = r.uniform(0, 2, (500, 1)).astype(F)
    pdf[:20] = 0.0
    pdf[20:30] = np.nan
    _close(bt.weight(torch.from_numpy(f), torch.from_numpy(pdf)),
           bj.weight(jnp.asarray(f), jnp.asarray(pdf)), "weight")


def test_render_with_transparent_matches_jax(closures):
    sc, mats_j, bj, bt = closures
    cfgd = dict(CFG)
    img_j = jax.jit(lambda k: jshader.render_with_bsdf(
        k, jshader.RenderConfig(**cfgd), JCam(RES, RES), sc["gj"], mats_j,
        jnp.asarray(sc["env"]), bj))(jax.random.PRNGKey(12))
    with torch.no_grad():
        img_t = tshader.render_with_bsdf(
            rng.key(12), tshader.RenderConfig(**cfgd), Camera(RES, RES),
            sc["gt_buf"], port_materials(mats_j),
            torch.from_numpy(sc["env"]), bt)
    assert np.isfinite(img_t.numpy()).all()
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=2e-2,
                               atol=2e-2)


def test_transparent_is_differentiable(closures):
    """The albedo gradient of a transparent render flows through the
    K = 15 table (row gather forward, scatter-add backward)."""
    sc, mats_j, _, _ = closures
    mats = port_materials(mats_j)
    alb = mats.albedo.clone().requires_grad_()
    mats = mats._replace(albedo=alb)
    n = RES * RES
    mask = torch.zeros((RES, RES), dtype=torch.bool)
    mask[8:24, 6:26] = True
    bt = tbsdf.transparent(mats, torch.full((RES, RES, 3), 0.5), mask, 0.4,
                           1.2, Camera(RES, RES),
                           sc["gt_buf"].position.reshape(n, 3))
    img = tshader.render_with_bsdf(
        rng.key(13), tshader.RenderConfig(**CFG), Camera(RES, RES),
        sc["gt_buf"], mats, torch.from_numpy(sc["env"]), bt)
    img.sum().backward()
    assert torch.isfinite(alb.grad).all() and float(alb.grad.abs().max()) > 0


@pytest.fixture(scope="module")
def cli_render(tmp_path_factory):
    root = tmp_path_factory.mktemp("trans_scene")
    trans_golden_scene_dir(root)
    from materialist_tpu_torch.cli import trans_edit
    mp = pytest.MonkeyPatch()
    mp.setattr(tconfig, "OUT_DIR", str(root))
    try:
        img = trans_edit.transparency_edit("transfix", 1.2, False, 0.4,
                                           n_iter=2, spp=8, device="cpu")
    finally:
        mp.undo()
    return img, os.path.join(str(root), "transfix")


def test_trans_edit_cli_files_and_stats(cli_render):
    img, out_dir = cli_render
    stem = "mi_trans_1.2_woA_0.4_transfix_envmap"
    for ext in ("exr", "png"):
        assert os.path.exists(os.path.join(out_dir, f"{stem}.{ext}"))
    assert np.isfinite(img).all() and 0.005 < img.mean() < 2.0
    # the PNG holds the linear image under the sRGB transfer of the writer
    png = image_io.read(os.path.join(out_dir, f"{stem}.png"))[..., :3]
    np.testing.assert_allclose(png, image_io.srgb_encode(img), atol=1 / 255)
    inside = img[20:44, 20:44]
    outside = np.concatenate([img[:12].reshape(-1, 3),
                              img[52:].reshape(-1, 3)])
    r_in = inside[..., 0].mean() / max(inside[..., 1].mean(), 1e-6)
    r_out = outside[..., 0].mean() / max(outside[..., 1].mean(), 1e-6)
    assert r_in > r_out + 0.05, (r_in, r_out)


def test_trans_edit_cli_meets_the_golden(cli_render):
    img, _ = cli_render
    srgb = np.clip(img, 0.0, 1.0) ** (1 / 2.2)
    gold = image_io.read(GOLDEN)[..., :3]
    mse = float(np.mean((srgb - gold) ** 2))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    assert psnr > 30.0, f"trans_edit drifted from the golden: {psnr:.2f} dB"
