"""The port's bench (``materialist_tpu_torch/bench.py``) against the JAX
package's ``bench.py`` on the CPU.

- the bench's resize equals ``jax.image.resize(..., "bilinear")`` up
  (512 → 1024) and down (512 → 32, 37 → 16, where the triangle widens) on
  seeded arrays within 1e-6;
- its loader at 32² equals the same calls of the JAX package (its
  ``load_best_results``, ``make_gbuffer``, ``Camera`` and
  ``jax.image.resize``) on photo_e2e within 1e-6: G-buffer, materials,
  envmap and ground truth;
- one fresh iteration of its step (32², 4 spp in chunks of 2, the
  ``--cpu-fast`` march, its loss, Adam 3e-4) equals the JAX package's
  ``make_phase_step`` + ``optax.adam(3e-4)`` from the same key, the JAX
  fused bounce in interpret mode: the loss within 5e-3 relative and the
  gradients (the JAX side's from Adam's first moment) by
  ``torch_step_common.check_grad``; where a gradient is at least 5% of
  its maximum (its sign settled) the updates agree within 1e-3 of the
  learning rate;
- ``main`` on the CPU at 32² prints a last line with every key of the
  result line and no ``vs_baseline``, nor any rate from assumed constants
  (``ASSUMED``);
- a missing scene file raises: there is no synthetic fallback;
- the material adjoint's cotangent rows (what ``_ReuseGather.backward``
  scatters, kernel C′) are exactly zero for a vertex whose march missed
  (uncompacted) and for a compacted bounce's padding rows, and not all
  zero elsewhere: chip_smoke.py's scatter row at the bench's chunk zeroes
  the missed rows' noise on this ground.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.io import exr as jexr
from materialist_tpu.ops.color import linear_to_srgb as jsrgb
from materialist_tpu.opt.step import make_phase_step as jmake
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu.render.scene import load_best_results as jload
from materialist_tpu.render.scene import make_gbuffer as jgbuf
from materialist_tpu.render.shader import RenderConfig as JCfg
from materialist_tpu_torch import bench, rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.opt import schedules
from materialist_tpu_torch.opt.step import make_phase_step, param_list
from materialist_tpu_torch.render import bsdf as bsdf_mod
from materialist_tpu_torch.render.scene import Materials, make_gbuffer
from materialist_tpu_torch.render.shader import RenderConfig, n_chunks_of
from torch_step_common import check_grad, jax_fused_shade

torch.set_num_threads(2)

RES = 32
RESULT_KEYS = {"metric", "value", "unit", "amortized_ms_per_iter",
               "trace_every", "trace_pass_ms", "fresh_ms_each",
               "relight_fps", "device"}
# rates of an assumed byte and operation model over the host's time
ASSUMED = ("paths_per_s_M", "est_hbm_roofline_frac", "est_tflops",
           "est_bytes_per_s_G")


def jax_resize(x, res):
    """bench.py's ``rs``."""
    x = jnp.asarray(x)
    if x.ndim == 2:
        x = x[..., None]
    if x.shape[0] != res:
        x = jax.image.resize(x, (res, res, x.shape[-1]), "bilinear")
    return np.asarray(x)


def jax_scene(res):
    """bench.py's ``load`` on photo_e2e: (cam, gbuf, mats, envmap, gt)."""
    base = bench.SCENE
    mat = jload(os.path.join(base, "best_results"), roughness_remap=False)
    depth = jax_resize(jexr.read(os.path.join(base, "depthPred.exr"))
                       [..., :1], res)
    gt = jax_resize(jexr.read(os.path.join(base, "gt_image.exr")), res)
    mats = JMats(*(jnp.asarray(jax_resize(mat[k], res))
                   for k in ("albedo", "roughness", "metallic", "normal")))
    cam = JCam(res, res)
    return cam, jgbuf(jnp.asarray(depth[..., 0]), cam, flip_depth=True), \
        mats, jnp.asarray(mat["envmap"]), jnp.asarray(gt)


@pytest.mark.parametrize("shape,res", [((512, 512, 3), 1024),
                                       ((512, 512, 1), 32),
                                       ((37, 37, 2), 16)])
def test_resize_matches_jax(shape, res):
    x = np.random.default_rng(sum(shape) + res).uniform(
        0, 1, shape).astype(np.float32)
    got = bench.resize(x, res)
    ref = jax_resize(x, res)
    assert got.shape == ref.shape == (res, res, shape[-1])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_loader_matches_jax():
    scene = bench.load_scene(bench.SCENE, RES, "cpu")
    cam, gb, mats, env, gt = jax_scene(RES)
    assert (scene.cam.height, scene.cam.width) == (cam.height, cam.width)
    np.testing.assert_array_equal(scene.gbuf.valid.numpy(),
                                  np.asarray(gb.valid))
    pairs = [(f"gbuf.{n}", a, b) for n, a, b in zip(
        scene.gbuf._fields, scene.gbuf, gb) if n != "valid"]
    pairs += [(f"mats.{n}", a, b) for n, a, b in zip(
        scene.mats._fields, scene.mats, mats)]
    pairs += [("envmap", scene.envmap, env), ("gt", scene.gt, gt)]
    for name, a, b in pairs:
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_fresh_iteration_matches_jax():
    spp, chunk = 4, 2
    # the port: the bench's own scene, step and Adam
    scene = bench.load_scene(bench.SCENE, RES, "cpu")
    cfg = bench.render_config(spp, cpu_fast=True)._replace(chunk=chunk)
    phase, step = bench.build_step(cfg, scene, None, "cpu")
    params = bench.make_params(scene)
    start = {k: v.detach().clone() for k, v in params.items()}
    state = schedules.adam_plain(bench.LR).init(param_list(params))
    loss_t, _ = bench.one_iter(phase, step, params, state, rng.key(1))
    grads_t = {k: g.numpy() / 0.1 for k, g in zip(bench.PARAMS,
                                                   state["mu"])}

    # the JAX package, as bench.py builds its step
    cam, gb, mats, env, gt = jax_scene(RES)
    gt_srgb = jsrgb(gt)

    def maps_of(p, extra):
        return p["mats"], p["envmap"]

    def loss_of(maps, img, extra):
        pred = jsrgb(img)
        loss = jnp.mean((pred - gt_srgb) ** 2) + jnp.mean(
            jnp.abs(pred - gt_srgb))
        return loss, loss

    jcfg = JCfg(spp=spp, chunk=chunk, march_impl="exact",
                march_vectorized=True, march_steps=8, shadow_steps=8)
    opt = optax.adam(bench.LR)
    pj = {"mats": mats, "envmap": env}
    with jax_fused_shade():
        ph = jmake(jcfg, cam, gb, maps_of, loss_of)
        jstep = ph.make_step(opt)
        recs = ph.trace_all(pj, None, jax.random.PRNGKey(1))
        p1_j, st_j, loss_j, _, _ = jstep(pj, opt.init(pj), None, *recs)
        loss_j = float(loss_j)
    mu = st_j[0].mu
    grads_j = dict(zip(bench.PARAMS, (np.asarray(x) / 0.1 for x in (
        *mu["mats"], mu["envmap"]))))
    p1_j = dict(zip(bench.PARAMS, (np.asarray(x) for x in (
        *p1_j["mats"], p1_j["envmap"]))))

    assert np.isfinite(float(loss_t))
    assert abs(float(loss_t) - loss_j) <= 5e-3 * abs(loss_j)
    for name in ("albedo", "roughness", "metallic", "envmap"):
        check_grad(name, grads_t[name], grads_j[name])
    for name in bench.PARAMS:
        g_r = grads_j[name]
        settled = np.abs(g_r) >= 0.05 * np.abs(g_r).max()
        assert settled.any(), name
        p0 = start[name].numpy()
        np.testing.assert_allclose(
            (params[name].detach().numpy() - p0)[settled],
            (p1_j[name] - p0)[settled], rtol=0, atol=1e-3 * bench.LR,
            err_msg=name)


def test_main_prints_the_result_line(capsys):
    report = bench.main(["--device", "cpu", "--cpu-fast", "--res", "32",
                         "--spp", "2", "--fresh-iters", "1",
                         "--trace-every", "2", "--relight-res", "32",
                         "--relight-frames", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == RESULT_KEYS and "vs_baseline" not in last
    assert last == report["result"]
    assert last["metric"] == \
        "inverse_opt_fresh_trace_ms_per_iter_32sq_2spp_measured"
    assert last["unit"] == "ms" and last["trace_every"] == 2
    assert len(last["fresh_ms_each"]) == 1
    for key in ("value", "amortized_ms_per_iter", "trace_pass_ms",
                "relight_fps"):
        assert np.isfinite(last[key]) and last[key] > 0, key
    assert last["device"] == "cpu"
    for key in ASSUMED:
        assert key not in last and key not in report, key
    # the headline was printed before the relight, without relight_fps
    first = json.loads(lines[-2])
    assert first["relight_fps"] is None and first["value"] == last["value"]


@pytest.mark.parametrize("missing", ["gt_image.exr",
                                     "best_results/envmap.hdr"])
def test_missing_scene_file_raises(tmp_path, missing):
    scene = tmp_path / "scene"
    shutil.copytree(bench.SCENE, scene)
    os.remove(scene / missing)
    with pytest.raises(FileNotFoundError, match=missing):
        bench.load_scene(str(scene), RES, "cpu")


@pytest.mark.parametrize("caps", [(), (0.5, 0.25)],
                         ids=["uncompacted", "compacted"])
def test_missed_vertices_carry_no_material_cotangent(monkeypatch, caps):
    r = np.random.default_rng(0)
    depth = (2.0 + 0.3 * r.uniform(size=(RES, RES))).astype(np.float32)
    depth[6:16, 8:22] -= 0.7
    depth[20:28, 3:12] -= 0.4
    cam = Camera(RES, RES)
    gbuf = make_gbuffer(depth, cam, flip_depth=False)

    def u(lo, hi, c):
        return torch.from_numpy(r.uniform(lo, hi, (RES, RES, c)).astype(
            np.float32))
    params = {"albedo": u(0.2, 0.9, 3), "roughness": u(0.2, 0.9, 1),
              "metallic": u(0.0, 0.5, 1), "normal": gbuf.normal_geo.clone(),
              "envmap": torch.from_numpy(((r.uniform(size=(16, 32, 3)) + 0.1)
                                          * 2).astype(np.float32))}
    params = {k: v.requires_grad_() for k, v in params.items()}
    gt = u(0.05, 0.6, 3)

    def loss_of(maps, img, extra):
        loss = torch.mean((img - gt) ** 2)
        return loss, loss.detach()

    cfg = RenderConfig(spp=4, chunk=2, march_steps=6, shadow_steps=4,
                       compact_caps=caps)
    phase = make_phase_step(cfg, cam, gbuf, bench.maps_of, loss_of,
                            device="cpu")
    records = phase.trace_all(params, None, rng.key(1))
    # the rows of each index array the shade pass hands the reuse gather
    # that belong to no live vertex
    dead = {}
    for chunk in records[0][0]:
        for rec in chunk:
            dead[rec.idx.data_ptr()] = ~rec.hit
            if rec.extras is not None:
                _, count, vtx, _ = rec.extras
                dead[vtx.data_ptr()] = torch.arange(vtx.shape[0]) >= count
    seen = []
    backward = bsdf_mod._ReuseGather.backward

    def recorded(ctx, cot):
        (idx,) = ctx.saved_tensors
        seen.append((dead[idx.data_ptr()], cot.detach().clone()))
        return backward(ctx, cot)
    monkeypatch.setattr(bsdf_mod._ReuseGather, "backward",
                        staticmethod(recorded))
    phase.value_and_grad(params, None, records)
    assert len(seen) == n_chunks_of(cfg) * (cfg.max_depth - 2)
    for d, cot in seen:
        d = d.reshape(cot.shape[:-1])
        assert d.any() and (~d).any()
        assert torch.equal(cot[d], torch.zeros_like(cot[d]))
        assert (cot[~d] != 0).any()
