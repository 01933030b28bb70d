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


def _gather_indices(n, shape, order, rng):
    """Indices in [0, n) of ``shape`` in the order of one family of
    callers of the gather."""
    size = int(np.prod(shape))
    if order == "sorted":          # sorted, repeats allowed
        idx = np.sort(rng.integers(0, n, size))
    elif order == "gaps":          # ascending with gaps: a compaction's
        idx = np.sort(rng.choice(n, size, replace=False))
    elif order == "random":        # uniform: hit indices
        idx = rng.integers(0, n, size)
    elif order == "repeats":       # a few rows fetched over and over
        idx = rng.choice(rng.integers(0, n, 3), size)
    return idx.astype(np.int32).reshape(shape)


_GATHER_CASES = [
    pytest.param(300, 6, (1024,), "sorted", id="300-6-shape0"),
    pytest.param(64, 3, (2, 500), "sorted", id="64-3-shape1"),
    pytest.param(2048, 5, (700,), "sorted", id="2048-5-shape2"),
] + [pytest.param(1000, k, shape, order, id=f"k{k}-{order}")
     for k in (3, 5, 6, 8, 13, 15, 20)
     for order, shape in (("gaps", (3, 111)), ("random", (777,)),
                          ("repeats", (2, 50)), ("single", (1,)))]


@pytest.mark.parametrize("n,k,shape,order", _GATHER_CASES)
def test_row_gather_matches_jax(n, k, shape, order):
    """Every width the tracer gathers (15 is the run-time route), in the
    orders of its callers; ``exact=False`` against the JAX result rounded
    to bf16, which is what the TPU kernel's DEFAULT precision gives (off
    the TPU JAX's own gather is always exact)."""
    rng = np.random.default_rng(n + k)
    tab = rng.normal(size=(n, k)).astype(np.float32)
    idx = (np.full(shape, n - 1, np.int32) if order == "single"
           else _gather_indices(n, shape, order, rng))
    coherent = order in ("sorted", "gaps", "single")
    ref = jrow.row_gather(jnp.asarray(tab), jnp.asarray(idx), exact=True,
                          coherent=coherent)
    got = trow.row_gather(_t(tab), _t(idx), exact=True, coherent=coherent)
    assert got.shape == shape + (k,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # exact=False: the fetched values rounded to bf16
    got16 = trow.row_gather(_t(tab), _t(idx), exact=False)
    np.testing.assert_array_equal(
        got16.numpy(), np.asarray(ref.astype(jnp.bfloat16).astype(
            jnp.float32)))


def _sectors_brute(idx, k, sector=32):
    """Distinct sectors of an (N, k) float32 table that the rows at idx
    touch, one byte at a time."""
    return len({(r * k * 4 + b) // sector for r in np.asarray(idx).ravel()
                for b in range(k * 4)})


@pytest.mark.parametrize("idx,k,sectors", [
    ([2], 3, 2),            # bytes 24..35: a 12-byte row over a boundary
    ([0, 1], 3, 1),         # bytes 0..23: two rows in one sector
    ([6, 6, 6, 6], 3, 1),   # bytes 72..83, fetched four times
    ([0], 20, 3),           # an 80-byte row: bytes 0..79
    ([1], 20, 3),           # bytes 80..159: sectors 2, 3, 4
    ([0, 1], 20, 5),        # the two share sector 2
    ([0, 8], 8, 2),         # 32-byte rows, one sector each
])
def test_gather_sector_bytes(idx, k, sectors):
    """The sector bound of the gather: each distinct sector once, plus 4
    bytes of index and 4·k of output a query."""
    from materialist_tpu_torch.utils.profiling import gather_sector_bytes
    ix = torch.tensor(idx, dtype=torch.int32)
    assert _sectors_brute(idx, k) == sectors
    assert gather_sector_bytes(ix, k) == 32 * sectors + len(idx) * (4 + 4 * k)


@pytest.mark.parametrize("k", [3, 5, 6, 13, 20])
def test_gather_sector_bytes_seeded(k):
    """Against the byte-by-byte count on seeded sorted, random and
    repeated indices, in 32- and 64-byte sectors."""
    from materialist_tpu_torch.utils.profiling import gather_sector_bytes
    rng = np.random.default_rng(k)
    for order in ("sorted", "random", "repeats"):
        idx = _gather_indices(500, (300,), order, rng)
        for sector in (32, 64):
            assert gather_sector_bytes(torch.from_numpy(idx), k, sector) == (
                sector * _sectors_brute(idx, k, sector)
                + idx.size * (4 + 4 * k)), (order, sector)
    assert gather_sector_bytes(torch.zeros((0,), dtype=torch.int32), k) == 0


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


@pytest.mark.parametrize("case", ["none_alive", "all_alive", "over_cap",
                                  "ragged"])
def test_compact_sel_edge_cases_match_jax(case):
    """None alive, all alive, more alive than the cap, and a ray count
    that is no multiple of 1024 (nor of 16)."""
    rng = np.random.default_rng(len(case))
    m, cap = {"none_alive": (2048, 1024), "all_alive": (2048, 2048),
              "over_cap": (4096, 1024), "ragged": (3001, 2048)}[case]
    alive = {"none_alive": np.zeros(m, bool), "all_alive": np.ones(m, bool),
             "over_cap": rng.uniform(size=m) < 0.6,
             "ragged": rng.uniform(size=m) < 0.4}[case]
    sel_j, count_j = jrow.compact_sel(jnp.asarray(alive), cap)
    sel_t, count_t = trow.compact_sel(_t(alive), cap)
    assert sel_t.dtype == torch.int32 and sel_t.shape == (cap,)
    assert count_t.dtype == torch.int32 and count_t.shape == ()
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert int(count_t) == int(count_j) == min(int(alive.sum()), cap)
    if case == "over_cap":
        assert int(alive.sum()) > cap


def _scatter_inputs(pattern, k, seed):
    """coherent: live rows at ascending unique indices, then zero padding
    rows at index 0 (a compaction's scatter); skewed: 95% of the rows on
    one index (a bounce whose misses all carry index 0)."""
    rng = np.random.default_rng(seed)
    m, n_rows = 3000, 5000
    cot = rng.normal(size=(m, k)).astype(np.float32)
    if pattern == "coherent":
        live = 2100
        idx = np.zeros(m, np.int32)
        idx[:live] = np.sort(rng.permutation(n_rows)[:live])
        cot[live:] = 0.0
    else:
        idx = np.where(rng.uniform(size=m) < 0.95, 7,
                       rng.integers(0, n_rows, m)).astype(np.int32)
    return cot, idx, n_rows


@pytest.mark.parametrize("exact", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("pattern", ["coherent", "skewed"])
def test_row_scatter_add_matches_jax(pattern, k, exact):
    """f32: within 1e-5 of the row maximum (another order of the sums);
    bf16 payload: within 2^-8 of Σ|cot| of the rows that land on an entry
    (each contribution rounds to 8 significant bits)."""
    cot, idx, n_rows = _scatter_inputs(pattern, k, 10 * k + exact)
    ref = np.asarray(jrow.row_scatter_add(jnp.asarray(cot), jnp.asarray(idx),
                                          n_rows))
    got = trow.row_scatter_add(_t(cot), _t(idx), n_rows, exact=exact,
                               coherent=pattern == "coherent").numpy()
    assert got.shape == (n_rows, k) and got.dtype == np.float32
    if exact:
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    else:
        mass = np.zeros((n_rows, k), np.float64)
        np.add.at(mass, idx, np.abs(cot))
        assert (np.abs(got - ref) <= 2.0 ** -8 * mass + 1e-6).all()
        ref16 = np.asarray(jrow.row_scatter_add(
            jnp.asarray(_bf16(cot)), jnp.asarray(idx), n_rows))
        np.testing.assert_allclose(got, ref16,
                                   atol=1e-5 * np.abs(ref16).max())


def test_scatter_add_coherent_into_matches_jax():
    """The film accumulation in place: value and gradients equal to the
    JAX package's acc + scatter_add_coherent_diff(...)."""
    rng = np.random.default_rng(5)
    m0, cap = 4096, 1024
    idx = _sel(rng, m0, cap, 900)
    vals = rng.normal(size=(cap, 3)).astype(np.float32)
    vals[900:] = 0.0
    acc0 = rng.normal(size=(m0, 3)).astype(np.float32)
    cot = rng.normal(size=(m0, 3)).astype(np.float32)
    out_j, pull = jax.vjp(
        lambda a, v: a + jrow.scatter_add_coherent_diff(m0, v,
                                                        jnp.asarray(idx)),
        jnp.asarray(acc0), jnp.asarray(vals))
    a_leaf = _t(acc0).requires_grad_()
    vt = _t(vals).requires_grad_()
    acc = a_leaf * 1.0                      # the running buffer (no leaf)
    out_t = trow.scatter_add_coherent_into(acc, vt, _t(idx))
    assert out_t.data_ptr() == acc.data_ptr()      # added in place
    out_t.backward(_t(cot))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    ga, gv = pull(jnp.asarray(cot))
    np.testing.assert_array_equal(a_leaf.grad.numpy(), np.asarray(ga))
    np.testing.assert_array_equal(vt.grad.numpy(), np.asarray(gv))
    # twice into one buffer, as two compacted bounces of a chunk do
    buf = torch.zeros((m0, 3))
    buf = trow.scatter_add_coherent_into(buf, vt.detach(), _t(idx))
    buf = trow.scatter_add_coherent_into(buf, vt.detach(), _t(idx))
    np.testing.assert_allclose(
        buf.numpy(), 2 * np.asarray(jrow.scatter_add_coherent_diff(
            m0, jnp.asarray(vals), jnp.asarray(idx))), rtol=1e-6)


def test_launch_counts_by_shape():
    from materialist_tpu_torch.ops.kernels import _lib
    _lib.reset_launches()
    # row_gather's shape: table rows, width, queries, ascending indices
    _lib.count_launch("row_gather", (10, 3, 4, 1))
    _lib.count_launch("row_gather", (10, 3, 4, 1))
    _lib.count_launch("row_gather", (10, 3, 4, 0))
    _lib.count_launch("compact_sel", (8, 4))
    _lib.count_launch("march_pair")
    assert _lib.LAUNCHES["row_gather"] == 3
    assert _lib.LAUNCHES["march_pair"] == 1
    assert _lib.LAUNCHES_BY_SHAPE == {("row_gather", (10, 3, 4, 1)): 2,
                                      ("row_gather", (10, 3, 4, 0)): 1,
                                      ("compact_sel", (8, 4)): 1}
    _lib.reset_launches()
    assert not _lib.LAUNCHES_BY_SHAPE and not any(_lib.LAUNCHES.values())


def test_kernel_names_cover_every_global_function():
    """The profiler summary counts the port's kernels by the names
    ``_lib.kernel_names`` reads from the sources: one for every
    ``__global__`` function, none of them a name the counters lack a
    kernel for."""
    import os
    import re

    from materialist_tpu_torch.ops.kernels import _lib
    names = _lib.kernel_names()
    n_global = sum(len(re.findall(r"__global__", open(
        os.path.join(_lib.CSRC, src)).read())) for src in _lib.SOURCES)
    assert len(names) == len(set(names)) == n_global
    # every name parsed, launch bounds and all
    assert all(nm.endswith("_kernel") for nm in names), names
    assert {"march_kernel", "compact_count_kernel",
            "compact_write_kernel"} <= set(names)
    assert set(_lib.KERNELS_PER_LAUNCH) <= set(_lib.LAUNCHES)
