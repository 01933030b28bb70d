"""MaterialNet parity of materialist_tpu_torch against materialist_tpu on
the CPU: the resize ops, DINOv2, the DPT heads and the whole net at small
widths with the JAX package's parameters carried over by
``matnet_from_flax``; a reference-layout state dict loaded by both
packages (``load_state_dict`` here, ``convert_matnet`` there); and
``MatNetInference`` on the in-repo checkpoint and photo, against the JAX
package and against the predictions recorded with it.

Inputs are seeded numpy. Tolerances: the resizes agree within 1e-4 (f32
interpolation weights computed in another order); the nets within 1e-4
relative to the largest output, Flax's LayerNorm taking the variance as
E[x²]−E[x]² and PyTorch's in two passes; the checkpoint's maps within
1e-3 of the JAX package's.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.models import convert as jconvert
from materialist_tpu.models import dinov2 as jdino
from materialist_tpu.models import dpt as jdpt
from materialist_tpu.models import matnet as jmatnet
from materialist_tpu.ops import resize as jresize
from materialist_tpu_torch.io import exr as exr_io
from materialist_tpu_torch.io import image as image_io
from materialist_tpu_torch.models import convert as tconvert
from materialist_tpu_torch.models import dinov2 as tdino
from materialist_tpu_torch.models import dpt as tdpt
from materialist_tpu_torch.models import matnet as tmatnet
from materialist_tpu_torch.ops import resize as tresize
from torch_matnet_common import seeded_params as _seeded_params

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "output_imgs", "runs", "photo_e2e")
CKPT = os.path.join(REPO, "runs", "matnet_r5", "matnet_scratch.npz")
# a small MaterialNet: 4 encoder layers, each one a level of the heads
TINY = dict(features=16, out_channels=(8, 16, 32, 64),
            layer_idx=(0, 1, 2, 3), embed_dim=32, enc_depth=4, num_heads=2)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x_nhwc).transpose(0, 3, 1, 2)))


def _nhwc(x_nchw):
    return x_nchw.detach().numpy().transpose(0, 2, 3, 1)


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


# ------------------------------------------------------------------ resize

def test_bilinear_align_corners_matches_jax():
    x = np.random.default_rng(0).random((2, 7, 9, 4)).astype(np.float32)
    ref = jresize.bilinear_align_corners(jnp.asarray(x), (13, 21))
    got = _nhwc(tresize.bilinear_align_corners(_nchw(x), (13, 21)))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("grid", [5, 13, 40])
def test_bicubic_scale_matches_jax(grid):
    """The pos-embed interpolation: a 37×37 grid to ``grid``, with the
    +0.1 offset the encoder adds."""
    x = np.random.default_rng(grid).normal(
        0, 0.02, (37, 37, 16)).astype(np.float32)
    s = ((grid + 0.1) / 37, (grid + 0.1) / 37)
    ref = np.asarray(jresize.bicubic_scale(jnp.asarray(x), s))
    got = _nhwc(tresize.bicubic_scale(_nchw(x[None]), s))[0]
    assert got.shape == ref.shape == (grid, grid, 16)
    np.testing.assert_allclose(got, ref, atol=1e-4 * 0.02)


@pytest.mark.parametrize("hw,size", [((512, 512), (518, 518)),
                                     ((300, 400), (518, 686))])
def test_bicubic_resize_matches_cv2(hw, size):
    x = np.random.default_rng(1).random(hw + (3,)).astype(np.float32)
    ref = cv2.resize(x, size[::-1], interpolation=cv2.INTER_CUBIC)
    got = _nhwc(tresize.bicubic_resize(_nchw(x[None]), size))[0]
    assert tmatnet.lower_bound_size(*hw) == size
    assert jmatnet.resize_lower_bound(x).shape[:2] == size
    np.testing.assert_allclose(got, ref, atol=1e-4)


# ------------------------------------------------------------------ modules

@pytest.mark.parametrize("side", [70, 518], ids=["grid5_interp",
                                                 "grid37_identity"])
def test_dinov2_matches_jax(side):
    cfg = dict(embed_dim=32, depth=4, num_heads=2)
    layers = (0, 1, 2, 3)
    x = np.random.default_rng(side).random(
        (1, side, side, 3)).astype(np.float32)
    jnet = jdino.DINOv2(**cfg)
    params = _seeded_params(jnet, 1, jnp.asarray(x), layers)
    ref = jax.jit(jnet.apply, static_argnums=2)(
        {"params": params}, jnp.asarray(x), layers)
    tnet = tdino.DINOv2(**cfg)
    tnet.load_state_dict(tconvert.matnet_from_flax(params))
    with torch.no_grad():
        got = tnet(_nchw(x), layers)
    assert len(got) == len(ref) == 4
    for gt_, (rt, _cls) in zip(got, ref):
        assert _rel_err(gt_.numpy(), rt) < 1e-4


@pytest.mark.parametrize("output_type", ["depth", "material"])
def test_dpt_head_matches_jax(output_type):
    ph, pw, c = 5, 6, 32
    rng = np.random.default_rng(2)
    levels = [rng.normal(size=(1, ph * pw, c)).astype(np.float32)
              for _ in range(4)]
    jhead = jdpt.DPTHead(16, (8, 16, 32, 64), output_type)
    jl = [jnp.asarray(t) for t in levels]
    params = _seeded_params(jhead, 3, jl, ph, pw)
    ref = np.asarray(jax.jit(jhead.apply, static_argnums=(2, 3))(
        {"params": params}, jl, ph, pw))
    thead = tdpt.DPTHead(c, 16, (8, 16, 32, 64), output_type)
    thead.load_state_dict(tconvert.matnet_from_flax(params))
    with torch.no_grad():
        got = _nhwc(thead([torch.from_numpy(t) for t in levels], ph, pw))
    assert got.shape == ref.shape == (1, 14 * ph, 14 * pw,
                                      1 if output_type == "depth" else 8)
    assert _rel_err(got, ref) < 1e-4


def _maps_close(got, ref, rel=1e-4):
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.shape == r.shape, k
        assert _rel_err(g, r) < rel, (k, _rel_err(g, r))


def test_matnet_from_flax_matches_jax():
    """The whole net at a 98×126 input (7×9 patches: a grid that is not
    square, so a token reshape that swaps rows and columns shows)."""
    x = np.random.default_rng(4).random((1, 98, 126, 3)).astype(np.float32)
    jnet = jdpt.MaterialNet(**TINY)
    params = _seeded_params(jnet, 5, jnp.asarray(x))
    ref = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x))
    tnet = tdpt.MaterialNet(**TINY)
    tnet.load_state_dict(tconvert.matnet_from_flax(params))
    with torch.no_grad():
        got = {k: _nhwc(v) for k, v in tnet(_nchw(x)).items()}
    _maps_close(got, ref)


class _Recording(dict):
    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def _reference_state_dict(seed):
    """A state dict in the reference's layout at the small width: the
    port's names and shapes, seeded values, plus the reference's dead
    keys (mask token, refinenet4's first residual unit)."""
    g = torch.Generator().manual_seed(seed)
    sd = dict(tdpt.MaterialNet(**TINY, generator=g).state_dict())
    for k, v in sd.items():
        if not k.endswith("weight") or ".norm" in k:   # biases, scales
            sd[k] = v + 0.05 * torch.randn(v.shape, generator=g)
    sd["pretrained.mask_token"] = torch.zeros(1, TINY["embed_dim"])
    for head in ("depth_head", "material_head"):
        # lift the last biases so that no ReLU'd map is all zero
        sd[f"{head}.scratch.output_conv2.2.bias"] += 0.3
        f = TINY["features"]
        for conv in ("conv1", "conv2"):
            p = f"{head}.scratch.refinenet4.resConfUnit1.{conv}."
            sd[p + "weight"] = torch.randn((f, f, 3, 3), generator=g)
            sd[p + "bias"] = torch.randn((f,), generator=g)
    return sd


def test_reference_state_dict_loads_in_both():
    """The names the JAX package's converter reads are exactly the port's
    names, and the same reference weights give the same forward."""
    sd = _reference_state_dict(6)
    rec = _Recording({k: v.numpy() for k, v in sd.items()})
    params = jconvert.convert_matnet(rec)
    dead = {k for k in sd if k == "pretrained.mask_token"
            or ".refinenet4.resConfUnit1." in k}
    assert len(dead) == 9
    tnet = tdpt.MaterialNet(**TINY)
    tnet.load_state_dict(tconvert.from_reference(sd))      # strict
    assert rec.read == set(tnet.state_dict()) == set(sd) - dead

    x = np.random.default_rng(7).random((1, 70, 84, 3)).astype(np.float32)
    ref = jax.jit(jdpt.MaterialNet(**TINY).apply)({"params": params},
                                                  jnp.asarray(x))
    with torch.no_grad():
        got = {k: _nhwc(v) for k, v in tnet(_nchw(x)).items()}
    _maps_close(got, ref)


def test_pth_route_matches_jax(tmp_path, monkeypatch):
    """A reference ``.pth`` through both packages' ``MatNetInference``
    (explicit path here, ``$MATNET_WEIGHTS`` there), on a 60×80 photo
    resized to the lower bound of 70 and restored."""
    path = str(tmp_path / "matnet_weights.pth")
    torch.save(_reference_state_dict(8), path)
    monkeypatch.delenv("MATNET_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError, match="MATNET_WEIGHTS"):
        tconvert.load_matnet_params()
    img = np.random.default_rng(9).random((60, 80, 3)).astype(np.float32)
    got = tmatnet.MatNetInference(weights_path=path, device="cpu",
                                  net=tdpt.MaterialNet(**TINY)).infer_image(
        img, input_size=70)
    monkeypatch.setenv("MATNET_WEIGHTS", path)
    assert set(tconvert.load_matnet_params()) == set(
        tdpt.MaterialNet(**TINY).state_dict())
    ref = jmatnet.MatNetInference(net=jdpt.MaterialNet(**TINY)).infer_image(
        img, input_size=70)
    assert got["depth"].shape == got["roughness"].shape == (60, 80)
    assert got["albedo"].shape == got["normal"].shape == (60, 80, 3)
    _maps_close(got, ref)


# ------------------------------------------------------------------ photo

@pytest.fixture(scope="module")
def photo_maps():
    img = exr_io.read(os.path.join(FIXTURE, "gt_image.exr"))[..., :3]
    got = tmatnet.MatNetInference(weights_path=CKPT,
                                  device="cpu").infer_image(img)
    ref = jmatnet.MatNetInference(weights_path=CKPT).infer_image(img)
    return got, ref


def test_checkpoint_on_photo_matches_jax(photo_maps):
    got, ref = photo_maps
    assert set(got) == set(ref) == {"albedo", "normal", "roughness",
                                    "metallic", "depth"}
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= 1e-3, (k, err)


def test_checkpoint_on_photo_matches_recorded(photo_maps):
    """The predictions the JAX package recorded on a TPU (bf16 passes):
    a loose anchor, mean abs albedo ≤ 2e-3, normal ≤ 8e-3, max abs depth
    ≤ 1e-2; roughness and metallic went through 8-bit sRGB PNGs, mean
    abs ≤ 8e-3 there."""
    got, _ = photo_maps
    rec = {n: exr_io.read(os.path.join(FIXTURE, f"{n}Pred.exr"))[..., :3]
           for n in ("albedo", "normal")}
    assert np.abs(got["albedo"] - rec["albedo"]).mean() <= 2e-3
    assert np.abs(got["normal"] - rec["normal"]).mean() <= 8e-3
    depth = exr_io.read(os.path.join(FIXTURE, "depthPred.exr"))[..., 0]
    assert np.abs(got["depth"] - depth).max() <= 1e-2
    for n in ("roughness", "metallic"):
        png = image_io.read(os.path.join(FIXTURE, f"{n}Pred.png"))
        png = png[..., 0] if png.ndim == 3 else png
        err = np.abs(image_io.srgb_encode(got[n]) - png).mean()
        assert err <= 8e-3, (n, err)
