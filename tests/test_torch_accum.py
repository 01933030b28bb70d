"""Exact gradient accumulation of the port (``opt/accum.py``) on the CPU,
on the 32² scene of ``torch_step_common`` (2 spp a group in one chunk,
max_depth 3, march steps 6/4, film jitter 0.5; loss MSE + L1 of sRGB).

- every variant (split with and without kept records, the
  ``trace_all`` / ``records=`` route, the scan-named variant, the legacy
  render-twice variant) equals one autograd backward through the mean of
  the same per-group renders: the loss within 1e-6 relative, each
  gradient within 1e-5 of its maximum;
- the split variant equals the JAX package's
  ``make_accum_value_and_grad_split`` on the same inputs and keys (its
  fused bounce in Pallas interpret mode): the loss within 5e-3 relative
  and the gradients by ``check_grad``, as the step parity tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.ops.color import linear_to_srgb as jsrgb
from materialist_tpu.opt.accum import \
    make_accum_value_and_grad_split as jsplit
from materialist_tpu.render import shader as jsh
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.ops.color import linear_to_srgb
from materialist_tpu_torch.opt import accum
from materialist_tpu_torch.render import shader as tsh
from materialist_tpu_torch.render.scene import Materials
from torch_step_common import (CFG, RES, check_grad, jax_fused_shade,
                               make_scene)

torch.set_num_threads(2)

GROUP_CFG = dict(CFG, spp=2, chunk=2)
G = 3
NAMES = ("albedo", "roughness", "metallic", "envmap")


@pytest.fixture(scope="module")
def setup():
    sc = make_scene()
    cfg = tsh.RenderConfig(**GROUP_CFG)
    cam = Camera(RES, RES)
    gbuf = sc["gt_buf"]
    gt = linear_to_srgb(torch.from_numpy(sc["gt"]))

    def params():
        def leaf(k):
            return torch.from_numpy(sc[k]).clone().requires_grad_()
        return {"mats": Materials(leaf("alb"), leaf("rough"), leaf("met"),
                                  gbuf.normal_geo),
                "envmap": leaf("env")}

    def loss_of_img(img):
        pred = linear_to_srgb(img)
        return torch.mean((pred - gt) ** 2) + torch.mean(torch.abs(pred - gt))

    def trace_fn(p, key):
        return tsh.trace_step_records(key, cfg, cam, gbuf, p["mats"],
                                      p["envmap"])

    def shade_fn(p, recs, key):
        return tsh.shade_from_records(key, recs, cfg, cam, gbuf, p["mats"],
                                      p["envmap"])

    def render_fn(p, key):
        return tsh.render_with_bsdf(key, cfg, cam, gbuf, p["mats"],
                                    p["envmap"])

    return dict(sc=sc, params=params, loss_of_img=loss_of_img,
                trace_fn=trace_fn, shade_fn=shade_fn, render_fn=render_fn)


def _flat(p):
    return [*p["mats"][:3], p["envmap"]]


@pytest.fixture(scope="module")
def monolithic(setup):
    """One backward through loss(mean of the G per-group renders)."""
    p = setup["params"]()
    keys = rng.split(rng.key(11), G)
    img = sum(setup["render_fn"](p, keys[g]) for g in range(G)) / G
    loss = setup["loss_of_img"](img)
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() for t in _flat(p)]


def _split(s, keep):
    return accum.make_accum_value_and_grad_split(
        s["trace_fn"], s["shade_fn"], s["loss_of_img"], G,
        keep_records=keep)


VARIANTS = {
    "split_keep_records": lambda s, p, k: _split(s, True)(p, k),
    "split_retrace": lambda s, p, k: _split(s, False)(p, k),
    "split_trace_all": lambda s, p, k: (
        lambda vg: vg(p, k, records=vg.trace_all(p, k)))(_split(s, True)),
    "scan": lambda s, p, k: accum.make_accum_value_and_grad_scan(
        s["trace_fn"], s["shade_fn"], s["loss_of_img"], G)(p, k),
    "legacy": lambda s, p, k: accum.make_accum_value_and_grad(
        s["render_fn"], s["loss_of_img"], G)(p, k),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_accum_matches_monolithic_backward(setup, monolithic, variant):
    p = setup["params"]()
    loss, grads = VARIANTS[variant](setup, p, rng.key(11))
    loss_ref, grads_ref = monolithic
    assert abs(float(loss) - loss_ref) <= 1e-6 * abs(loss_ref)
    assert isinstance(grads["mats"], Materials)
    assert torch.equal(grads["mats"].normal,
                       torch.zeros_like(grads["mats"].normal))
    for name, got, ref in zip(NAMES, _flat(grads), grads_ref):
        assert all(t.grad is None for t in _flat(p)), name
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


def test_split_accum_matches_jax(setup):
    s = setup
    sc = s["sc"]
    cfg = jsh.RenderConfig(**GROUP_CFG)
    cam = JCam(RES, RES)
    gj = sc["gj"]
    gt = jsrgb(jnp.asarray(sc["gt"]))

    def loss_of_img(img):
        pred = jsrgb(img)
        return jnp.mean((pred - gt) ** 2) + jnp.mean(jnp.abs(pred - gt))

    def trace_fn(p, key):
        return jsh.trace_step_records(key, cfg, cam, gj, p["mats"],
                                      p["envmap"])

    def shade_fn(p, recs, key):
        return jsh.shade_from_records(key, recs, cfg, cam, gj, p["mats"],
                                      p["envmap"])

    params = {"mats": JMats(jnp.asarray(sc["alb"]), jnp.asarray(sc["rough"]),
                            jnp.asarray(sc["met"]), gj.normal_geo),
              "envmap": jnp.asarray(sc["env"])}
    with jax_fused_shade():
        loss_j, g_j = jsplit(trace_fn, shade_fn, loss_of_img, G)(
            params, jax.random.PRNGKey(11))
        loss_j = float(loss_j)
    loss_t, g_t = _split(s, True)(s["params"](), rng.key(11))
    assert abs(float(loss_t) - loss_j) <= 5e-3 * abs(loss_j)
    for name, got, ref in zip(NAMES, _flat(g_t),
                              (g_j["mats"].albedo, g_j["mats"].roughness,
                               g_j["mats"].metallic, g_j["envmap"])):
        check_grad(name, got.numpy(), np.asarray(ref))
