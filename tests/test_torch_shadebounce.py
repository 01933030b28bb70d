"""The fused bounce of the port (plain forward of kernel B and the
explicit adjoint of kernel B′) against the JAX package's
shade_bounce_fused in Pallas interpret mode, and the explicit adjoint
against torch.autograd of the plain forward.

Tolerances: forward rtol 1e-4 (same float order, different compilers),
backward rtol 1e-3 (the JAX adjoint is jax.vjp of the kernel math, the
port's is derived by hand: the same function, other rounding), explicit
vs autograd rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.ops.pallas import shadebounce as jsb
from materialist_tpu_torch.ops.kernels import shadebounce as tsb

torch.set_num_threads(2)


def _records(seed, s=2, n=640, h=16, w=32):
    rng = np.random.default_rng(seed)

    def unit(shape):
        v = rng.normal(size=shape)
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)

    nrm = unit((s, n, 3))
    wo = unit((s, n, 3))
    wo = np.where(np.sum(wo * nrm, -1, keepdims=True) < 0, -wo, wo)
    win = unit((s, n, 3))
    wie = unit((s, n, 3))
    gates = (rng.uniform(size=(s, n, 2)) > 0.3).astype(np.float32)
    aux = np.concatenate([wo, win, gates], -1)
    pdf_e = rng.uniform(0.05, 3.0, (s, n, 1))
    pdf_at = rng.uniform(0.05, 3.0, (s, n, 1))
    uvf = rng.uniform(0, 1, (s, n, 4))
    uvi = np.stack([rng.integers(0, w, (s, n)), rng.integers(0, h, (s, n)),
                    rng.integers(0, w, (s, n)), rng.integers(0, h, (s, n))],
                   -1)
    recb = np.concatenate([pdf_e, pdf_at, wie, uvf, uvi], -1)
    blob = np.concatenate([rng.uniform(0.05, 0.95, (s, n, 3)),
                           rng.uniform(0.1, 1.0, (s, n, 1)),
                           rng.uniform(0.0, 1.0, (s, n, 1))],
                          -1).astype(np.float32)
    thr = rng.uniform(0.1, 1.5, (s, n, 3)).astype(np.float32)
    env = (rng.uniform(size=(h, w, 3)) * 2 + 0.1).astype(np.float32)
    ct = rng.normal(size=(2, s, n, 3)).astype(np.float32)
    # the records as the trace stores them: f16 normal, bf16 planes
    nrmf = torch.from_numpy(nrm).to(torch.float16)
    auxb = torch.from_numpy(aux.astype(np.float32)).to(torch.bfloat16)
    recbb = torch.from_numpy(recb.astype(np.float32)).to(torch.bfloat16)
    return dict(env=env, blob=blob, thr=thr, nrmf=nrmf, aux=auxb,
                recb=recbb, ct=ct)


def _jnp(t):
    """A torch record as the same-typed JAX array."""
    dt = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}[t.dtype]
    return jnp.asarray(t.to(torch.float32).numpy()).astype(dt)


@pytest.fixture(scope="module")
def jax_reference():
    r = _records(0)
    jsb._INTERPRET = True
    try:
        args = (jnp.asarray(r["env"]), jnp.asarray(r["blob"]),
                jnp.asarray(r["thr"]))
        det = (_jnp(r["nrmf"]), _jnp(r["aux"]), _jnp(r["recb"]))
        out, pull = jax.vjp(
            lambda e, b, t: jsb.shade_bounce_fused(e, b, t, *det), *args)
        grads = pull((jnp.asarray(r["ct"][0]), jnp.asarray(r["ct"][1])))
    finally:
        jsb._INTERPRET = False
    return r, [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


def _port(r):
    env = torch.from_numpy(r["env"]).requires_grad_()
    blob = torch.from_numpy(r["blob"]).requires_grad_()
    thr = torch.from_numpy(r["thr"]).requires_grad_()
    out = tsb.shade_bounce_fused(env, blob, thr, r["nrmf"], r["aux"],
                                 r["recb"])
    torch.autograd.backward(out, [torch.from_numpy(c) for c in r["ct"]])
    return [o.detach().numpy() for o in out], [
        x.grad.numpy() for x in (env, blob, thr)]


def test_forward_matches_jax_interpret(jax_reference):
    r, out_j, _ = jax_reference
    out_t, _ = _port(r)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * np.abs(b).max())


def test_backward_matches_jax_interpret(jax_reference):
    r, _, g_j = jax_reference
    _, g_t = _port(r)
    for name, a, b in zip(("envmap", "blob", "thr"), g_t, g_j):
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("seed", [1, 2])
def test_explicit_adjoint_matches_autograd(seed):
    r = _records(seed)
    m = r["blob"].shape[0] * r["blob"].shape[1]
    env = torch.from_numpy(r["env"]).requires_grad_()
    blob = torch.from_numpy(r["blob"].reshape(m, 5)).requires_grad_()
    thr = torch.from_numpy(r["thr"].reshape(m, 3)).requires_grad_()
    det = (r["nrmf"].reshape(m, 3), r["aux"].reshape(m, 8),
           r["recb"].reshape(m, 13))
    ct = [torch.from_numpy(c.reshape(m, 3)) for c in r["ct"]]
    out = tsb.shade_bounce_fwd_plain(env, blob, thr, *det)
    torch.autograd.backward(out, ct)
    d_blob, d_thr, d_le = tsb.shade_bounce_bwd_explicit(
        env.detach(), blob.detach(), thr.detach(), *det, *ct)
    d_env = tsb._denv_from_dle(env.detach(), det[2], d_le)
    for name, a, b in (("blob", d_blob, blob.grad), ("thr", d_thr, thr.grad),
                       ("envmap", d_env, env.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(b.abs().max()),
                                   err_msg=name)


def _tap_records(seed, h, w):
    """Seeded records at an h×w envmap whose fetch coords include the seam
    (u0 = w−1), the pole (v0 = h−1), both at once, and 96 rows that all
    tap the same bins; about 30% of each look is gated off."""
    r = _records(seed, h=h, w=w)
    rec = r["recb"].reshape(-1, 13).to(torch.float32)
    rng = np.random.default_rng(seed + 100)
    for look in range(2):
        iu, iv = 9 + 2 * look, 10 + 2 * look
        rec[0:40, iu] = w - 1
        rec[40:80, iv] = h - 1
        rec[80:120, iu] = w - 1
        rec[80:120, iv] = h - 1
        rec[120:216, iu] = int(rng.integers(0, w))
        rec[120:216, iv] = int(rng.integers(0, h))
    r["recb"] = rec.to(torch.bfloat16).reshape(r["recb"].shape)
    return r


@pytest.mark.parametrize("h,w", [(16, 32), (8, 8), (64, 64)])
@pytest.mark.parametrize("seed", [3, 4])
def test_tap_scatter_matches_jax_denv(seed, h, w):
    """The sum kernel B′ implements (denv_taps: eight weighted taps a row
    through index_add_, float64) against the JAX package's one-hot
    contraction _denv_from_dle (float32 on the CPU) on the same fetch
    cotangents: the explicit adjoint's d_le, zero on gated-off looks.
    Tolerance: 2e-6 of the largest bin, about 20× the float32 rounding of
    these sums (their distance from float64 stays under 1e-7)."""
    r = _tap_records(seed, h, w)
    m = r["blob"].shape[0] * r["blob"].shape[1]
    recb = r["recb"].reshape(m, 13)
    aux = r["aux"].reshape(m, 8).to(torch.float32)
    assert (recb[:, 9].float() == w - 1).any() and (
        recb[:, 10].float() == h - 1).any()
    assert (aux[:, 6] == 0).any() and (aux[:, 7] == 0).any()
    _, _, d_le = tsb.shade_bounce_bwd_explicit(
        torch.from_numpy(r["env"]), torch.from_numpy(r["blob"].reshape(m, 5)),
        torch.from_numpy(r["thr"].reshape(m, 3)), r["nrmf"].reshape(m, 3),
        r["aux"].reshape(m, 8), recb,
        *[torch.from_numpy(c.reshape(m, 3)) for c in r["ct"]])
    assert float(d_le[aux[:, 6] == 0, 0:3].abs().max()) == 0.0
    assert float(d_le[aux[:, 7] == 0, 3:6].abs().max()) == 0.0
    got = tsb.denv_taps(h, w, recb, d_le).numpy()
    ref = np.asarray(jsb._denv_from_dle(
        jnp.asarray(r["env"]), _jnp(recb), jnp.asarray(d_le.numpy())))
    assert got.shape == ref.shape == (h, w, 3)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-6 * np.abs(got).max())


def test_bounce_bwd_on_cpu_is_its_plain_version(monkeypatch):
    """On CPU tensors B′'s wrapper returns the plain composite's d_env,
    _denv_from_dle of the explicit d_le, bit for bit; without an envmap
    gradient it returns None, and the bounce's backward does not build
    the contraction when the envmap needs no gradient."""
    r = _tap_records(5, 16, 32)
    m = r["blob"].shape[0] * r["blob"].shape[1]
    env = torch.from_numpy(r["env"])
    blob = torch.from_numpy(r["blob"].reshape(m, 5))
    thr = torch.from_numpy(r["thr"].reshape(m, 3))
    det = (r["nrmf"].reshape(m, 3), r["aux"].reshape(m, 8),
           r["recb"].reshape(m, 13))
    ct = [torch.from_numpy(c.reshape(m, 3)) for c in r["ct"]]
    d_blob, d_thr, d_env = tsb.shade_bounce_bwd(env, blob, thr, *det, *ct)
    e_blob, e_thr, d_le = tsb.shade_bounce_bwd_explicit(env, blob, thr,
                                                        *det, *ct)
    assert torch.equal(d_blob, e_blob) and torch.equal(d_thr, e_thr)
    assert torch.equal(d_env, tsb._denv_from_dle(env, det[2], d_le))
    n_blob, n_thr, none = tsb.shade_bounce_bwd(env, blob, thr, *det, *ct,
                                               env_grad=False)
    assert none is None
    assert torch.equal(n_blob, e_blob) and torch.equal(n_thr, e_thr)

    def no_contraction(*a):
        raise AssertionError("_denv_from_dle called without an envmap "
                             "gradient")
    monkeypatch.setattr(tsb, "_denv_from_dle", no_contraction)
    blob_l = blob.clone().requires_grad_()
    out = tsb.shade_bounce_fused(env, blob_l, thr, *det)
    torch.autograd.backward(out, ct)
    assert env.grad is None
    torch.testing.assert_close(blob_l.grad, e_blob, rtol=0, atol=0)
