"""The port's multi-device layer on the CPU: gloo ranks spawned through
``parallel/dryrun.py`` on the 32² scene of ``torch_step_common`` (4 spp
in chunks of 1, max_depth 3, march steps 6/4, film jitter 0.5).

- 1, 2, 3 and 4 ranks run the four asserts of the JAX package's dry run at
  its bounds (``dryrun.assert_agree``); a rank's ``sys.modules`` holds
  nothing of JAX or of the JAX package after them; so does the first
  stage of the JAX dry run on its toy scene (``dryrun_multichip``),
  whose device, from Python and from its command line, is the card
  unless the caller asks for the CPU;
- ``make_mesh_2d`` lays four ranks out as (px, spp) = divmod(rank, 2);
- after an spp- and a px-sharded step, the parameters, gradients and
  Adam state are the same bit for bit on every rank;
- the two-rank px-sharded render (4 spp in one chunk) equals the JAX
  package's ``px_sharded_render`` on a 2-device "px" mesh of the virtual
  CPU devices, from the same key, within the step-parity image bounds
  (rtol / atol 2e-2);
- the two-rank spp- and px-sharded steps equal the JAX package's
  ``make_sharded_train_step`` and ``make_px_sharded_train_step`` on a
  2-device mesh, both with Adam (lr 1e-2, eps 1e-8), 2 spp, from the
  same key: the loss within 5e-3 relative and the gradients (the JAX
  side's from Adam's first moment) by ``check_grad``, as the step parity
  tests; where the gradient is at least 5% of its maximum (so its sign is
  settled) the parameter updates agree within 1e-3 of the learning rate.

Every spawn has its own deadline of 120 s."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.ops.color import linear_to_srgb as jsrgb
from materialist_tpu.parallel.mesh import make_mesh as jmake_mesh
from materialist_tpu.parallel.sharding import (make_px_sharded_train_step,
                                               make_sharded_train_step,
                                               px_sharded_render)
from materialist_tpu.render.scene import Materials as JMats
from materialist_tpu.render.shader import RenderConfig as JCfg
from materialist_tpu_torch.parallel import dryrun
from materialist_tpu_torch.parallel.mesh import make_mesh
from torch_rank_fns import mesh_2d_coords, px_render_rank, train_step_rank
from torch_step_common import (CFG, RES, check_grad, jax_fused_shade,
                               make_scene)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 120.0
ASSERT_CFG = dict(CFG, chunk=1)
STEP_CFG = dict(CFG, spp=2, chunk=1)
RENDER_CFG = dict(CFG, chunk=4)
LR = 1e-2
NAMES = ("albedo", "roughness", "metallic", "envmap")


@pytest.fixture(scope="module")
def scene():
    sc = make_scene()
    port = dict(depth=sc["depth"], flip_depth=False, albedo=sc["alb"],
                roughness=sc["rough"], metallic=sc["met"],
                envmap=sc["env"], gt=sc["gt"])
    return sc, port


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_dryrun_asserts_on_gloo_ranks(scene, world):
    """At 3 ranks (3 spp) the px paths leave the 32 % 3 trailing rows
    unrendered, as the JAX package does."""
    cfg = dict(ASSERT_CFG, spp=3 if world == 3 else 4)
    out = dryrun.run_ranks(dryrun.dryrun_rank, world, args=(scene[1], cfg),
                           device="cpu", timeout=DEADLINE)
    assert len(out) == world
    for r in out:
        assert [ln[:3] for ln in r["lines"]] == ["1/4", "2/4", "3/4", "4/4"]
        assert r["peak_bytes"] is None
        # a spawned rank pulls in nothing of the JAX side
        assert r["foreign_modules"] == []


@pytest.mark.parametrize("axis", ["spp", "px"])
def test_step_state_identical_across_ranks(scene, axis):
    out = dryrun.run_ranks(train_step_rank, 2,
                           args=(scene[1], STEP_CFG, axis, LR),
                           device="cpu", timeout=DEADLINE)
    assert all(r["identical"] for r in out)
    assert out[0]["loss"] == out[1]["loss"] and np.isfinite(out[0]["loss"])
    for key in ("params", "grads", "state"):
        for a, b in zip(out[0][key], out[1][key]):
            np.testing.assert_array_equal(a, b)
    # the step moved every parameter it had a gradient for
    for p, p0 in zip(out[0]["params"], (scene[0]["alb"], scene[0]["rough"],
                                        scene[0]["met"], scene[0]["env"])):
        assert not np.array_equal(p, p0)


def _jax_maps(sc):
    return (JMats(jnp.asarray(sc["alb"]), jnp.asarray(sc["rough"]),
                  jnp.asarray(sc["met"]), sc["gj"].normal_geo),
            jnp.asarray(sc["env"]))


def _step_matches_jax(scene, axis):
    """One two-rank step of the port against the JAX package's step of
    the same axis on a 2-device mesh, both with Adam from key 1."""
    sc, port = scene
    mats, env = _jax_maps(sc)
    params = {"mats": mats, "envmap": env}
    opt = optax.adam(LR, eps=1e-8)
    make = make_sharded_train_step if axis == "spp" else \
        make_px_sharded_train_step
    mesh = jmake_mesh(2, axis=axis)
    step = make(mesh, JCfg(**STEP_CFG), JCam(RES, RES), opt, axis=axis)
    with jax_fused_shade(), mesh:
        p_j, st_j, loss_j = step(params, opt.init(params),
                                 jax.random.PRNGKey(1), sc["gj"],
                                 jsrgb(jnp.asarray(sc["gt"])))
        loss_j = float(loss_j)
    mu = st_j[0].mu
    g_j = [np.asarray(x) / 0.1 for x in (mu["mats"].albedo,
                                         mu["mats"].roughness,
                                         mu["mats"].metallic, mu["envmap"])]
    p1_j = [np.asarray(x) for x in (p_j["mats"].albedo, p_j["mats"].roughness,
                                    p_j["mats"].metallic, p_j["envmap"])]

    out = dryrun.run_ranks(train_step_rank, 2,
                           args=(port, STEP_CFG, axis, LR),
                           device="cpu", timeout=DEADLINE)[0]
    assert abs(out["loss"] - loss_j) <= 5e-3 * abs(loss_j)
    p0 = (sc["alb"], sc["rough"], sc["met"], sc["env"])
    for name, g_t, g_r, p_t, p_r, start in zip(NAMES, out["grads"], g_j,
                                               out["params"], p1_j, p0):
        check_grad(name, g_t, g_r)
        settled = np.abs(g_r) >= 0.05 * np.abs(g_r).max()
        assert settled.any(), name
        np.testing.assert_allclose((p_t - start)[settled],
                                   (p_r - start)[settled], rtol=0,
                                   atol=1e-3 * LR, err_msg=name)


def test_spp_step_matches_jax(scene):
    _step_matches_jax(scene, "spp")


def test_px_step_matches_jax(scene):
    """Each rank renders and back-propagates its 16 rows keyed by
    fold_in(key, rank); the loss and the gradients are SUMs over ranks."""
    _step_matches_jax(scene, "px")


def test_px_render_matches_jax(scene):
    sc, port = scene
    mats, env = _jax_maps(sc)
    mesh = jmake_mesh(2, axis="px")
    render = px_sharded_render(mesh, JCfg(**RENDER_CFG), JCam(RES, RES))
    with jax_fused_shade(), mesh:
        img_j = np.asarray(render(jax.random.PRNGKey(2), sc["gj"], mats,
                                  env))
    out = dryrun.run_ranks(px_render_rank, 2, args=(port, RENDER_CFG, 2),
                           device="cpu", timeout=DEADLINE)
    assert img_j.shape == (RES, RES, 3)
    for img_t in out:
        assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
        np.testing.assert_allclose(img_t, img_j, rtol=2e-2, atol=2e-2)


def test_dryrun_multichip_toy_scene():
    """The JAX dry run's first stage, on its toy scene at 16²."""
    out = dryrun.dryrun_multichip(2, device="cpu", res=16, timeout=DEADLINE)
    assert all(len(r["lines"]) == 4 and not r["foreign_modules"]
               for r in out)


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    """Without a card the default device is an error, not the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(2, res=16, timeout=DEADLINE)


def test_run_ranks_defaults_to_the_card(monkeypatch):
    """``run_ranks`` without a device runs on the card: without one it
    raises before it starts a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.run_ranks(mesh_2d_coords, 2, args=(1, 2), timeout=DEADLINE)


def test_dryrun_command_line_defaults_to_the_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "materialist_tpu_torch.parallel.dryrun",
         "--world", "1", "--res", "16"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=DEADLINE)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


def test_mesh_2d_layout():
    """make_mesh_2d(2, 2) lays the ranks out as the JAX package's
    make_mesh_2d lays out devices: reshape(n_px, n_spp)."""
    out = dryrun.run_ranks(mesh_2d_coords, 4, args=(2, 2), device="cpu",
                           timeout=DEADLINE)
    assert sorted(out) == [(r, r // 2, r % 2, 2, 2) for r in range(4)]


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(2, "spp", "cpu")
