"""The MG data path of the port against the JAX package on the CPU: the
scene generator's draws (``make_scene``), ``generate``'s EXR tree, and
``MGDataset``'s samples and batches on a seeded EXR tree.

Bounds: ``make_scene``'s maps within 1e-6 (XLA's sin/cos against
PyTorch's differ in the last bit), its envmap bit-equal; ``generate``'s
albedo, material, depth and normal files bit-equal, its image within a
mean relative error of 2e-2 (the JAX package shades in Pallas interpret
mode; its CPU sky fetch rounds its weights to bf16); the loader's
batches bit-equal."""

import os

import jax
import numpy as np
import pytest
import torch

from materialist_tpu.io import exr as jexr
from materialist_tpu.models.dataset import MGDataset as JDataset
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.cli import make_mg_dataset as tmg
from materialist_tpu_torch.io import exr as texr
from materialist_tpu_torch.models.dataset import MGDataset as TDataset
from materialist_tpu_torch.render import shader as tsh
from materialist_tpu_torch.render.scene import Materials, make_gbuffer
from scripts import make_mg_dataset as jmg
from torch_step_common import jax_fused_shade

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("hw", [(14, 28), (224, 336)])
def test_make_scene_matches_jax(seed, hw):
    ref = [np.asarray(x) for x in jmg.make_scene(jax.random.PRNGKey(seed),
                                                 *hw)]
    got = [x.numpy() for x in tmg.make_scene(rng.key(seed), *hw)]
    for name, g, r in zip(("depth", "albedo", "roughness", "metallic"),
                          got, ref):
        assert g.shape == r.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-6, err_msg=name)
    assert got[4].shape == (16, 32, 3)
    np.testing.assert_array_equal(got[4], ref[4])


def test_generate_matches_jax(tmp_path):
    """One scene of one sample at 14×28, 2 spp, seed 0."""
    with jax_fused_shade():
        jmg.generate(str(tmp_path / "jax"), 1, 1, 14, 28, 2)
    tmg.generate(str(tmp_path / "port"), 1, 1, 14, 28, 2, device="cpu")
    assert ((tmp_path / "port" / "train.txt").read_text()
            == (tmp_path / "jax" / "train.txt").read_text())
    for name in ("albedo", "material", "depth", "normal", "im"):
        a = texr.read(str(tmp_path / "port" / "scene000" / f"0_{name}.exr"))
        b = jexr.read(str(tmp_path / "jax" / "scene000" / f"0_{name}.exr"))
        assert a.shape == b.shape, name
        if name == "im":
            assert np.isfinite(a).all()
            assert np.abs(a - b).mean() / np.abs(b).mean() <= 2e-2
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_exact_render_takes_any_film_size():
    """The "exact" march builds no mip, so a film whose sides the mip
    factor does not divide renders (the JAX package takes it too)."""
    h, w = 35, 42                       # mip factor 2, 35 odd
    depth, alb, rough, metal, env = tmg.make_scene(rng.key(3), h, w)
    gb = make_gbuffer(depth, Camera(h, w), flip_depth=False)
    cfg = tsh.RenderConfig(spp=2, chunk=2, march_steps=8, shadow_steps=8,
                           march_impl="exact", march_vectorized=True)
    with torch.no_grad():
        img = tsh.render(rng.key(4), cfg, Camera(h, w), gb,
                         Materials(alb, rough, metal, gb.normal_geo), env)
    assert img.shape == (h, w, 3) and bool(torch.isfinite(img).all())


def test_generate_refuses_cpu_without_request(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmg.generate(str(tmp_path), 1, 1, 14, 28, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmg.main([str(tmp_path), "--scenes", "1"])


def _exr_tree(root, h=24, w=32, n=3):
    """The seeded scene of tests/test_train.py:73-100 (mask included)."""
    scene = root / "scene1"
    scene.mkdir()
    r = np.random.default_rng(0)
    for i in range(n):
        for name, arr in (
                ("im", r.random((h, w, 3))), ("albedo", r.random((h, w, 3))),
                ("material", r.random((h, w, 3))),
                ("depth", r.random((h, w, 1)) * 1000),
                ("normal", r.standard_normal((h, w, 3))),
                ("mask", np.ones((h, w, 1)))):
            jexr.write(str(scene / f"{i}_{name}.exr"), arr.astype(np.float32))
    (root / "train.txt").write_text("scene1\n")
    return str(root)


@pytest.mark.parametrize("hw", [(24, 32), (14, 28), (42, 56)],
                         ids=["native", "down", "up"])
def test_mgdataset_matches_jax(tmp_path, hw):
    """At the tree's size and resized (bilinear image and albedo, nearest
    maps), with random flips drawn from the same ``np.random`` seed."""
    root = _exr_tree(tmp_path)
    kw = dict(im_height=hw[0], im_width=hw[1], phase="TRAIN",
              random_flip=True)
    jd, td = JDataset(root, **kw), TDataset(root, **kw)
    assert len(td) == len(jd) == 3
    for epoch in range(3):
        np.random.seed(epoch)
        ref = list(jd.batches(2, seed=epoch))
        np.random.seed(epoch)
        got = list(td.batches(2, seed=epoch))
        assert len(got) == len(ref) == 1
        for k in ref[0]:
            assert got[0][k].dtype == ref[0][k].dtype, k
            np.testing.assert_array_equal(got[0][k], ref[0][k], err_msg=k)
    s = td[0]
    assert s["im"].shape == hw + (3,) and s["depth"].shape == hw + (1,)
    assert abs(np.linalg.norm(s["normal"], axis=-1) - 1).max() < 1e-3
    assert os.path.exists(td.im_list[0])
