"""The port's row gather (plain version of kernel C), ``compact_sel`` and
the differentiable compaction wrappers against
``materialist_tpu.ops.pallas.rowops`` on the CPU, from numpy-seeded
inputs. Forward values are selections, so they must be equal; adjoints
are f32 sums in another order, held to 1e-6 of the largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.ops.pallas import rowops as jrow
from materialist_tpu_torch.ops.kernels import rowops as trow

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _bf16(x):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16).to(
        torch.float32).numpy()


@pytest.mark.parametrize("n,k,shape", [(300, 6, (1024,)), (64, 3, (2, 500)),
                                       (2048, 5, (700,))])
def test_row_gather_matches_jax(n, k, shape):
    rng = np.random.default_rng(n)
    tab = rng.normal(size=(n, k)).astype(np.float32)
    idx = np.sort(rng.integers(0, n, shape).astype(np.int32), axis=-1)
    ref = np.asarray(jrow.row_gather(jnp.asarray(tab), jnp.asarray(idx),
                                     exact=True, coherent=True))
    got = trow.row_gather(_t(tab), _t(idx), exact=True, coherent=True)
    assert got.shape == shape + (k,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # exact=False: the fetched values rounded to bf16
    got16 = trow.row_gather(_t(tab), _t(idx), exact=False)
    np.testing.assert_array_equal(got16.numpy(), _bf16(ref))


@pytest.mark.parametrize("frac_alive,cap", [(0.3, 1024), (0.5, 1024),
                                            (0.5, 2048), (0.9, 1024),
                                            (0.0, 1024), (1.0, 4096)])
def test_compact_sel_matches_jax(frac_alive, cap):
    """Caps below, at and above the live count (2048 rays)."""
    m = 2048
    rng = np.random.default_rng(int(frac_alive * 100) + cap)
    alive = rng.uniform(size=m) < frac_alive
    if frac_alive == 0.5:
        alive[:] = False
        alive[rng.permutation(m)[:1024]] = True      # exactly 1024 live
    sel_j, count_j = jrow.compact_sel(jnp.asarray(alive), cap)
    sel_t, count_t = trow.compact_sel(_t(alive), cap)
    sel_p, count_p = trow.compact_sel_plain(_t(alive), cap)
    assert sel_t.dtype == torch.int32 and sel_t.shape == (cap,)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(sel_t.numpy(), sel_p.numpy())
    assert int(count_t) == int(count_j) == int(count_p) \
        == min(int(alive.sum()), cap)
    live = sel_t.numpy()[:int(count_t)]
    np.testing.assert_array_equal(live, np.nonzero(alive)[0][:cap])
    assert not sel_t.numpy()[int(count_t):].any()


def test_f32_exact_split_join():
    i = np.array([0, 1, 8191, 8192, 2 ** 20 + 17, 2 ** 24 - 1, 2 ** 26 - 1],
                 np.int32)
    hi, lo = trow._f32_exact_split(_t(i))
    hj, lj = jrow._f32_exact_split(jnp.asarray(i))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(trow._f32_exact_join(hi, lo).numpy(), i)


def _sel(rng, m, cap, live):
    alive = np.zeros(m, bool)
    alive[rng.permutation(m)[:live]] = True
    return trow.compact_sel_plain(_t(alive), cap)[0].numpy()


def test_gather_coherent_diff_matches_jax():
    rng = np.random.default_rng(1)
    m, cap = 3000, 1024
    tab = rng.normal(size=(m, 3)).astype(np.float32)
    sel = _sel(rng, m, cap, 700)
    cot = rng.normal(size=(cap, 3)).astype(np.float32)
    out_j, pull = jax.vjp(lambda t: jrow.gather_coherent_diff(
        t, jnp.asarray(sel)), jnp.asarray(tab))
    tt = _t(tab).requires_grad_()
    out_t = trow.gather_coherent_diff(tt, _t(sel))
    out_t.backward(_t(cot))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    ref = np.asarray(pull(jnp.asarray(cot))[0])
    np.testing.assert_allclose(tt.grad.numpy(), ref,
                               atol=1e-6 * np.abs(ref).max())
    np.testing.assert_array_equal(
        trow.gather_rows_coherent(_t(tab), _t(sel)).numpy(),
        np.asarray(jrow.gather_rows_coherent(jnp.asarray(tab),
                                             jnp.asarray(sel))))


def test_scatter_add_coherent_diff_matches_jax():
    rng = np.random.default_rng(2)
    m0, cap = 4096, 1024
    idx = _sel(rng, m0, cap, 900)
    vals = rng.normal(size=(cap, 3)).astype(np.float32)
    vals[900:] = 0.0                    # padding rows carry zero
    cot = rng.normal(size=(m0, 3)).astype(np.float32)
    out_j, pull = jax.vjp(lambda v: jrow.scatter_add_coherent_diff(
        m0, v, jnp.asarray(idx)), jnp.asarray(vals))
    vt = _t(vals).requires_grad_()
    out_t = trow.scatter_add_coherent_diff(m0, vt, _t(idx))
    out_t.backward(_t(cot))
    # distinct live slots: the forward is a placement, so it is equal
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(vt.grad.numpy(),
                                  np.asarray(pull(jnp.asarray(cot))[0]))


def test_row_gather_diff_matches_jax():
    """Forward equal; the port's adjoint is the JAX package's default
    accelerator adjoint (contributions rounded to bf16), so it is held
    against the JAX CPU adjoint of the bf16-rounded cotangent."""
    rng = np.random.default_rng(3)
    n, k = 400, 8
    tab = rng.normal(size=(n, k)).astype(np.float32)
    idx = rng.integers(0, n, (2, 900)).astype(np.int32)
    cot = rng.normal(size=(2, 900, k)).astype(np.float32)
    out_j, pull = jax.vjp(lambda t: jrow.row_gather_diff(
        t, jnp.asarray(idx)), jnp.asarray(tab))
    tt = _t(tab).requires_grad_()
    out_t = trow.row_gather_diff(tt, _t(idx))
    out_t.backward(_t(cot))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    ref = np.asarray(pull(jnp.asarray(_bf16(cot)))[0])
    np.testing.assert_allclose(tt.grad.numpy(), ref,
                               atol=1e-6 * np.abs(ref).max())
