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
