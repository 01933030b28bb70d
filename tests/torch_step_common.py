"""Shared set-up of the whole-slice step parity tests
(test_torch_step_env.py, test_torch_step_material.py): the 32² scene,
Flax weights carried to the port, one phase step in each package, and the
record-flag and gradient bounds.

Bounds: >= 99.5% of record flags equal; image rtol/atol 2e-2 (the JAX CPU
sky fetch rounds its weights to bf16, envmap.py:174-180); loss within
5e-3 relative; the elementwise, mean-relative and signed-bias gradient
bounds of test_shadebounce.py."""

import jax
import jax.numpy as jnp
import numpy as np

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.ops.pallas import shadebounce as jsb
from materialist_tpu.opt.step import make_phase_step as jmake
from materialist_tpu.render.scene import make_gbuffer as jgbuf
from materialist_tpu.render.shader import RenderConfig as JCfg
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.models.convert import posmlp_from_flax
from materialist_tpu_torch.opt.step import make_phase_step as tmake
from materialist_tpu_torch.render.scene import make_gbuffer
from materialist_tpu_torch.render.shader import RenderConfig

RES = 32
CFG = dict(spp=4, chunk=2, max_depth=3, march_steps=6, shadow_steps=4,
           film_jitter=0.5)
ELEM_TOL = {"albedo": 3e-2, "roughness": 0.12, "metallic": 3e-2,
            "envmap": 3e-2}


def make_scene():
    r = np.random.default_rng(0)
    depth = (2.0 + 0.3 * r.uniform(size=(RES, RES))).astype(np.float32)
    depth[6:16, 8:22] -= 0.7
    depth[20:28, 3:12] -= 0.4
    gt = r.uniform(0.05, 0.6, (RES, RES, 3)).astype(np.float32)
    alb = r.uniform(0.2, 0.9, (RES, RES, 3)).astype(np.float32)
    rough = r.uniform(0.2, 0.9, (RES, RES, 1)).astype(np.float32)
    met = r.uniform(0.0, 0.5, (RES, RES, 1)).astype(np.float32)
    env = ((r.uniform(size=(16, 32, 3)) + 0.1) * 2).astype(np.float32)
    gj = jgbuf(jnp.asarray(depth), JCam(RES, RES), flip_depth=False)
    gt_ = make_gbuffer(depth, Camera(RES, RES), flip_depth=False)
    return dict(depth=depth, gt=gt, alb=alb, rough=rough, met=met, env=env,
                gj=gj, gt_buf=gt_, nrm=np.asarray(gj.normal_geo))


def flax_params(net, x, seed, head_std):
    p = jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(1),
                                          jnp.asarray(x))["params"])
    r = np.random.default_rng(seed)
    for k in ("kernel", "bias"):
        p["lin_out"][k] = r.normal(0, head_std, p["lin_out"][k].shape).astype(
            np.float32)
    return p


def run_jax(sc, maps_of, loss_of, params, extra):
    jsb._INTERPRET = True
    try:
        ph = jmake(JCfg(**CFG), JCam(RES, RES), sc["gj"], maps_of, loss_of)
        recs = ph.trace_all(params, extra, jax.random.PRNGKey(11))
        loss, aux, grads = ph.value_and_grad(params, extra, recs)
    finally:
        jsb._INTERPRET = False
    return recs, float(loss), aux, grads


def run_port(sc, maps_of, loss_of, params, extra):
    ph = tmake(RenderConfig(**CFG), Camera(RES, RES), sc["gt_buf"], maps_of,
               loss_of, device="cpu")
    recs = ph.trace_all(params, extra, rng.key(11))
    loss, aux, grads = ph.value_and_grad(params, extra, recs)
    return recs, float(loss), aux, grads


def check_records(recs_j, recs_t):
    flags = []
    for c, chunk in enumerate(recs_t[0][0]):
        for b, rec in enumerate(chunk):
            rj = recs_j[0][c][b]
            for i, got in ((0, rec.shadowed), (1, rec.hit), (2, rec.idx)):
                flags.append(np.asarray(rj[i])[0] == got.numpy())
    agree = float(np.mean(np.concatenate([f.reshape(-1) for f in flags])))
    assert agree >= 0.995, f"record flags agree {agree:.4f}"


def check_grad(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a, b, atol=ELEM_TOL[name] * scale,
                               err_msg=f"grad mismatch: {name}")
    mean_rel = np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12)
    assert mean_rel <= 5e-2, f"{name} mean rel {mean_rel:.3f}"
    bias = abs((a - b).mean()) / max(np.abs(b).mean(), 1e-12)
    assert bias <= 1e-2, f"{name} signed bias {bias:.4f}"


def torch_net(net, params):
    net.load_state_dict(posmlp_from_flax(params))
    return net
