"""Module parity of materialist_tpu_torch against materialist_tpu on the
CPU: camera/G-buffer, BRDF, envmap sampler and lookups, row scatter-add,
PosMLP with converted weights, and one Adam/AdamW update. Inputs come
from seeded numpy and go through both packages."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu import camera as jcam
from materialist_tpu.models import posmlp as jposmlp
from materialist_tpu.ops import brdf as jbrdf
from materialist_tpu.ops import envmap as jem
from materialist_tpu.ops.pallas import rowops as jrow
from materialist_tpu.opt import schedules as jsched
from materialist_tpu.render import scene as jscene
from materialist_tpu_torch import camera as tcam
from materialist_tpu_torch.models import posmlp as tposmlp
from materialist_tpu_torch.models.convert import posmlp_from_flax
from materialist_tpu_torch.ops import brdf as tbrdf
from materialist_tpu_torch.ops import envmap as tem
from materialist_tpu_torch.ops.kernels import rowops as trow
from materialist_tpu_torch.opt import schedules as tsched
from materialist_tpu_torch.render import scene as tscene

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "output_imgs", "runs", "photo_e2e")


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _unit(rng, shape):
    v = rng.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ---------------------------------------------------------------- camera

def test_gbuffer_matches():
    rng = np.random.default_rng(0)
    depth = (1.0 + rng.uniform(size=(24, 32))).astype(np.float32)
    mask = rng.uniform(size=(24, 32)) > 0.8
    cam_j, cam_t = jcam.Camera(24, 32), tcam.Camera(24, 32)
    gj = jscene.make_gbuffer(jnp.asarray(depth), cam_j, mask=mask)
    gt = tscene.make_gbuffer(depth, cam_t, mask=mask)
    for name, a, b in zip(gj._fields, gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    p = rng.normal(size=(5, 3)).astype(np.float32)
    p[:, 2] = -np.abs(p[:, 2]) - 0.5
    np.testing.assert_allclose(cam_t.project(_t(p)).numpy(),
                               np.asarray(cam_j.project(jnp.asarray(p))),
                               rtol=1e-6)


def _sqrt_inputs():
    """100,000 seeded float32 in [0, 1], then 0, subnormals, 1 and a large
    value."""
    x = np.random.default_rng(7).uniform(size=100_000).astype(np.float32)
    edge = np.array([0.0, 1e-45, 3e-39, 1.1754942e-38, 1.0, 3.0e38],
                    np.float32)
    return np.concatenate([x, edge])


def _ulps(a, b):
    """Distance in float32 units in the last place of non-negative a, b."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("case", [
    "root", "gradient", pytest.param("card", marks=pytest.mark.cuda)])
def test_sqrt_rounds_correctly(case):
    """``camera.sqrt``: numpy's (correctly rounded) float32 root bit for bit
    on the CPU, its gradient within 1 ulp of 0.5 / sqrt(x) at x > 0, and on
    the card exactly ``torch.sqrt``."""
    x = _sqrt_inputs()
    if case == "root":
        got = tcam.sqrt(_t(x))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.sqrt(x).view(np.int32))
    elif case == "gradient":
        xt = _t(x[x > 0]).requires_grad_(True)
        tcam.sqrt(xt).sum().backward()
        g = xt.grad.numpy()
        want = (0.5 / np.sqrt(x[x > 0].astype(np.float64))).astype(np.float32)
        assert np.isfinite(g).all()
        assert _ulps(g, want).max() <= 1
    else:
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        xc = _t(x).cuda()
        got = tcam.sqrt(xc)
        assert got.dtype == torch.float32 and got.is_cuda
        assert torch.equal(got.view(torch.int32),
                           torch.sqrt(xc).view(torch.int32))


def test_load_best_results_matches():
    a = jscene.load_best_results(os.path.join(FIXTURE, "best_results"))
    b = tscene.load_best_results(os.path.join(FIXTURE, "best_results"))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------------ brdf

def test_brdf_eval_and_sampling():
    rng = np.random.default_rng(1)
    m = 4096
    n = _unit(rng, (m, 3))
    wo = _unit(rng, (m, 3))
    wi = _unit(rng, (m, 3))
    alb = rng.uniform(0.05, 1, (m, 3)).astype(np.float32)
    r = rng.uniform(0.07, 1, (m, 1)).astype(np.float32)
    met = rng.uniform(0, 1, (m, 1)).astype(np.float32)
    fj, pj = jbrdf.eval_brdf(*map(jnp.asarray, (wi, wo, n, alb, r, met)))
    ft, pt = tbrdf.eval_brdf(*map(_t, (wi, wo, n, alb, r, met)))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-6)
    u1 = rng.uniform(size=(m,)).astype(np.float32)
    u2 = rng.uniform(size=(m, 2)).astype(np.float32)
    dj = jbrdf.sample_dirs(*map(jnp.asarray, (u1, u2, wo, n, r)))
    dt = tbrdf.sample_dirs(*map(_t, (u1, u2, wo, n, r)))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- envmap

@pytest.fixture(scope="module")
def envmaps():
    rng = np.random.default_rng(2)
    env = (rng.uniform(size=(16, 32, 3)) * 2 + 0.05).astype(np.float32)
    return env, jem.build_sampler(jnp.asarray(env)), \
        tem.build_sampler(_t(env))


def test_sampler_tables(envmaps):
    _, sj, st = envmaps
    for name in ("c_cdf", "m_cdf", "c_pdf", "m_pdf"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_sample_dir_and_pdf_dir(envmaps):
    _, sj, st = envmaps
    rng = np.random.default_rng(3)
    u2 = rng.uniform(size=(3, 700, 2)).astype(np.float32)
    wj, pj = jem.sample_dir(sj, jnp.asarray(u2))
    wt, pt = tem.sample_dir(st, _t(u2))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5)
    d = _unit(rng, (3, 700, 3))
    np.testing.assert_allclose(tem.pdf_dir(st, _t(d)).numpy(),
                               np.asarray(jem.pdf_dir(sj, jnp.asarray(d))),
                               rtol=1e-5)


def test_bilinear_lookup_and_gradient(envmaps):
    env, _, _ = envmaps
    rng = np.random.default_rng(4)
    d = _unit(rng, (2, 500, 3))
    cj = jem.bilinear_coords(jnp.asarray(d), 16, 32)
    ct = tem.bilinear_coords(_t(d), 16, 32)
    for a, b in zip(cj[:2], ct[:2]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # fractions of u in [0, 32): a few ulps of u (atan2 differs in the
    # last bit between XLA and torch)
    for a, b in zip(cj[2:], ct[2:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=8e-6)
    cot = rng.normal(size=(2, 500, 3)).astype(np.float32)

    def jf(e):
        return jnp.sum(jem.lookup_bilinear(e, jnp.asarray(d)) * cot)
    vj, gj = jax.value_and_grad(jf)(jnp.asarray(env))
    et = _t(env).requires_grad_()
    lt = tem.lookup_bilinear(et, _t(d))
    torch.sum(lt * _t(cot)).backward()
    # the JAX CPU forward contracts bf16-quantized one-hot weights and a
    # bf16 envmap (envmap.py:174-180); the port's fetch is exact f32
    lj = np.asarray(jem.lookup_bilinear(jnp.asarray(env), jnp.asarray(d)))
    np.testing.assert_allclose(lt.detach().numpy(), lj, rtol=1.6e-2,
                               atol=1e-3)
    # both backwards are exact-f32 scatters of the bilinear weights
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------- rowops

@pytest.mark.parametrize("n,k,m", [(64, 8, 3000), (512, 3, 20000)])
def test_row_scatter_add(n, k, m):
    rng = np.random.default_rng(5)
    cot = rng.normal(size=(m, k)).astype(np.float32)
    idx = rng.integers(0, n, m).astype(np.int32)
    ref = np.asarray(jrow.row_scatter_add(jnp.asarray(cot),
                                          jnp.asarray(idx), n))
    got = trow.row_scatter_add(_t(cot), _t(idx), n, exact=True).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(),
                               rtol=1e-5)
    # bf16 contributions: each of a row's terms moves by <= 2^-9 relative
    got16 = trow.row_scatter_add(_t(cot), _t(idx), n, exact=False).numpy()
    bound = np.zeros((n, k), np.float32)
    np.add.at(bound, idx, np.abs(cot))
    assert np.all(np.abs(got16 - ref) <= bound * 2.0 ** -8 + 1e-6)


def test_row_gather_plain_indexing():
    rng = np.random.default_rng(6)
    tab = rng.normal(size=(50, 13)).astype(np.float32)
    idx = rng.integers(0, 50, (3, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        trow.row_gather(_t(tab), _t(idx)).numpy(),
        np.asarray(jrow.row_gather(jnp.asarray(tab), jnp.asarray(idx),
                                   exact=False)))


# --------------------------------------------------------------- PosMLP

@pytest.mark.parametrize("kind,rows,ch", [("envmap", 512, 3),
                                          ("arm", 1024, 5),
                                          ("armn", 1024, 8)])
def test_posmlp_converted(kind, rows, ch):
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (rows, ch)).astype(np.float32)
    net_j = (jposmlp.make_envmap_net() if kind == "envmap"
             else jposmlp.make_brdf_net(kind))
    params = jax.tree.map(np.asarray, net_j.init(jax.random.PRNGKey(1),
                                                 jnp.asarray(x))["params"])
    # a nonzero head, so the whole net is exercised
    params["lin_out"]["kernel"] = rng.normal(
        0, 0.05, params["lin_out"]["kernel"].shape).astype(np.float32)
    params["lin_out"]["bias"] = rng.normal(
        0, 0.05, params["lin_out"]["bias"].shape).astype(np.float32)
    net_t = (tposmlp.make_envmap_net() if kind == "envmap"
             else tposmlp.make_brdf_net(kind))
    net_t.load_state_dict(posmlp_from_flax(params))
    yj = np.asarray(net_j.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        yt = net_t(_t(x)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_adam_update(kind):
    import optax
    rng = np.random.default_rng(8)
    p0 = {"a": rng.normal(size=(7, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    grads[1]["b"][2] = np.nan          # non-finite: the update is skipped
    if kind == "adam":
        tx, opt = jsched.adam_steplr(1e-3), tsched.adam_steplr(1e-3)
    else:
        tx, opt = jsched.adamw_steplr(3e-4), tsched.adamw_steplr(3e-4)
    pj = jax.tree.map(jnp.asarray, p0)
    sj = tx.init(pj)
    pt = [_t(p0["a"]), _t(p0["b"])]
    st = opt.init(pt)
    for g in grads:
        upd, sj = tx.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        opt.step(pt, [_t(g["a"]), _t(g["b"])], st)
    assert st["count"] == 2
    np.testing.assert_allclose(pt[0].numpy(), np.asarray(pj["a"]), rtol=1e-5)
    np.testing.assert_allclose(pt[1].numpy(), np.asarray(pj["b"]), rtol=1e-5)


def test_step_lr_gated_staircase():
    for base, floor in ((3e-4, 1.5e-4), (1e-3, 0.0)):
        sj = jsched.step_lr(base, floor=floor)
        st = tsched.step_lr(base, floor=floor)
        for c in (0, 99, 100, 250, 401, 1000, 5000):
            assert abs(st(c) - float(sj(c))) <= 1e-6 * base
