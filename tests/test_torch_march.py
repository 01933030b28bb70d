"""The port's paired march (plain version of kernel A:
render/screenspace.py::march_mip twice) against the JAX package's
march_pair on the CPU. Tolerance: >= 99.9% of hit / idx / shadowed flags
equal (last-ulp float differences can flip a crossing at a silhouette)
and t within 1e-4 where both hit the same pixel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from materialist_tpu.camera import Camera as JCam
from materialist_tpu.ops.pallas.march_kernel import march_pair as jpair
from materialist_tpu.render.scene import make_gbuffer as jmk
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.ops.kernels import march as mk
from materialist_tpu_torch.render.scene import make_gbuffer
from materialist_tpu_torch.utils.seeded import (MARCH_CASES,
                                                march_case_inputs)
from materialist_tpu_torch.utils.seeded import march_scene as _scene

torch.set_num_threads(2)


@pytest.mark.parametrize("seed,shadow_fine", [(0, 2), (1, 0)])
def test_march_pair_matches_jax(seed, shadow_fine):
    res, s = 64, 2
    depth, mask = _scene(res, seed)
    gj = jmk(jnp.asarray(depth), JCam(res, res), flip_depth=False, mask=mask)
    gt = make_gbuffer(depth, Camera(res, res), flip_depth=False, mask=mask)
    rng = np.random.default_rng(seed + 10)
    n = res * res

    def hemi(nrm):
        v = rng.normal(size=(s, n, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        flip = np.sum(v * nrm, -1, keepdims=True) < 0
        return np.where(flip, -v, v).astype(np.float32)

    nrm = np.asarray(gj.normal_geo).reshape(1, n, 3)
    origin = np.broadcast_to(np.asarray(gj.position).reshape(1, n, 3),
                             (s, n, 3)).astype(np.float32)
    dl, dn = hemi(nrm), hemi(nrm)
    kw = dict(n_steps=24, fine_steps=6, shadow_steps=16,
              shadow_fine_steps=shadow_fine, interval_frac=0.05)
    hj, sj = jpair(JCam(res, res), gj.dist, gj.valid, jnp.asarray(origin),
                   jnp.asarray(dl), jnp.asarray(dn), **kw)
    tab = mk.march_tables(gt.dist, gt.valid)
    ht, st = mk.march_pair(Camera(res, res), tab, torch.from_numpy(origin),
                           torch.from_numpy(dl), torch.from_numpy(dn), **kw)
    for name, a, b in (("hit", hj.hit, ht.hit), ("idx", hj.idx, ht.idx),
                       ("shadowed", sj, st)):
        agree = float(np.mean(np.asarray(a) == b.numpy()))
        assert agree >= 0.999, f"{name} agreement {agree:.5f}"
    both = np.asarray(hj.hit) & ht.hit.numpy() & (np.asarray(hj.idx)
                                                  == ht.idx.numpy())
    assert both.mean() > 0.05          # the scene exercises real hits
    np.testing.assert_allclose(ht.t.numpy()[both], np.asarray(hj.t)[both],
                               atol=1e-4)


def test_march_factors_match_jax():
    from materialist_tpu.ops.pallas import march_kernel as jmkern
    for h, w in ((32, 32), (64, 64), (512, 512), (256, 512), (1024, 1024)):
        assert mk._mip_factor(h, w) == jmkern._mip_factor(h, w)
        assert mk._fine_factor(h, w) == jmkern._fine_factor(h, w)


# ---------------------------------------------------------------------------
# The march kernel's control flow, transcribed ray by ray: shifts for the
# power-of-two table factors, and loops that stop once nothing they could
# change is read any more. Held against march_mip (every loop at its full
# trip count, floor divisions) and against the same transcription without
# the exits and with C's truncating division.

F = np.float32


def _project(g, qx, qy, qz):
    inv = F(1.0) / max(F(-qz), F(1e-6))
    uf = g["cx"] + g["focal"] * qx * inv - F(0.5)
    vf = g["cy"] - g["focal"] * qy * inv - F(0.5)
    ui = int(np.floor(uf + F(0.5)))
    vi = int(np.floor(vf + F(0.5)))
    inside = 0 <= ui < g["w"] and 0 <= vi < g["h"] and qz < 0
    return ui, vi, inside


def _clamp(x, lo, hi):
    return min(max(x, lo), hi)


def _march_one(g, mip, fine, t_lo, o, d, n_steps, fine_steps, ratio,
               shadow_only, exits=True):
    """(hit, idx, t, stats) of one ray, as csrc/march_pair.cu::march_one
    computes them. ``exits=False``: every loop runs its full trip count
    and table cells come from C's truncating division (the kernel's first
    version)."""
    mf, ff = g["mip_f"], g["fine_f"]
    ms, fs = mf.bit_length() - 1, ff.bit_length() - 1
    mh, mw = mip.shape
    fh, fw = fine.shape

    def cell(ui, vi, f, s, th, tw):
        if exits:
            cu, cv = ui >> s, vi >> s
        else:
            cu, cv = int(ui / f), int(vi / f)
        return _clamp(cv, 0, th - 1) * tw + _clamp(cu, 0, tw - 1)

    ox, oy, oz = o
    dx, dy, dz = d
    stats = {"neg": False, "steps": 0}
    ui, vi, _ = _project(g, ox, oy, oz)
    start = cell(ui, vi, mf, ms, mh, mw)
    t = t_prev = t_lo
    prev_cand = exited = False
    edge_cnt = 0
    tb1 = tc1 = tb2 = tc2 = t_lo
    edges_read = 1 if shadow_only else 2
    for _ in range(n_steps):
        stats["steps"] += 1
        qx, qy, qz = ox + t * dx, oy + t * dy, oz + t * dz
        ui, vi, inside = _project(g, qx, qy, qz)
        stats["neg"] = stats["neg"] or ui < 0 or vi < 0
        mi = cell(ui, vi, mf, ms, mh, mw)
        cand = (inside and F(-qz) > mip.flat[mi] * g["bias_lo"]
                and mi != start and not exited)
        if cand and not prev_cand:
            if edge_cnt == 0:
                tb1, tc1 = t_prev, t
            elif edge_cnt == 1:
                tb2, tc2 = t_prev, t
            edge_cnt += 1
            if exits and edge_cnt >= edges_read:
                break
        if not inside and edge_cnt == 0:
            exited = True
            if exits:
                break
        prev_cand = cand
        t_prev = t
        t = t * ratio
    stats["edges"] = edge_cnt
    if shadow_only:
        return edge_cnt > 0, 0, tc1, stats
    hit = False
    t_hit, excess_hit, local_hit, idx_hit = tc1, F(0), F(1), 0
    for half in range(2):
        if exits and (half >= edge_cnt or hit):
            break
        lo_t = tb2 if half else tb1
        hi_t = (tc2 if half else tc1) * ratio
        for k in range(fine_steps):
            stats["steps"] += 1
            frac = (F(k) + F(1)) / F(fine_steps)
            tt = lo_t + (hi_t - lo_t) * frac
            qx, qy, qz = ox + tt * dx, oy + tt * dy, oz + tt * dz
            ui, vi, inside = _project(g, qx, qy, qz)
            surf = fine.flat[cell(ui, vi, ff, fs, fh, fw)]
            ray_d = F(-qz)
            if (inside and surf < F(1e29) and ray_d > surf * g["bias_hi"]
                    and edge_cnt > half and not hit):
                t_hit = tt
                idx_hit = (_clamp(vi, 0, g["h"] - 1) * g["w"]
                           + _clamp(ui, 0, g["w"] - 1))
                excess_hit = ray_d - surf * g["bias_hi"]
                local_hit = ray_d
                hit = True
                if exits:
                    break
    thin = excess_hit < g["interval_frac"] * max(local_hit, F(1e-6))
    return hit and thin, idx_hit, t_hit, stats


@pytest.mark.parametrize("case,shadow_only", MARCH_CASES)
def test_march_exits_and_shifts_match_march_mip(case, shadow_only):
    from materialist_tpu_torch.render import screenspace as ss
    res, n_rays = 32, 2000
    cam, tab, o, d, n_steps, fine_steps = march_case_inputs(case, shadow_only,
                                                            res, n_rays)
    ref = ss.march_mip(cam, tab.dist, tab.valid, tab.mip,
                       torch.from_numpy(o), torch.from_numpy(d),
                       n_steps=n_steps, fine_steps=fine_steps,
                       interval_frac=0.05, mip_factor=tab.mip_f,
                       shadow_only=shadow_only, fine_table=tab.fine,
                       fine_factor=tab.fine_f)
    g = dict(h=res, w=res, mip_f=4, fine_f=2, focal=F(cam.focal),
             cx=F(cam.cx), cy=F(cam.cy), bias_lo=F(1.0 - 4e-3),
             bias_hi=F(1.0 + 4e-3), interval_frac=F(0.05))
    mip, fine = tab.mip.numpy(), tab.fine.numpy()
    t_lo = F(tab.t_lo.numpy()[0])
    ratio = F((3.0 / 2e-3) ** (1.0 / (n_steps - 1)))
    got = [_march_one(g, mip, fine, t_lo, o[i], d[i], n_steps, fine_steps,
                      ratio, shadow_only) for i in range(n_rays)]
    full = [_march_one(g, mip, fine, t_lo, o[i], d[i], n_steps, fine_steps,
                       ratio, shadow_only, exits=False)
            for i in range(n_rays)]
    # the exits and the shifts change no output, bit for bit
    assert [x[:3] for x in got] == [x[:3] for x in full]
    assert sum(x[3]["steps"] for x in got) < sum(x[3]["steps"] for x in full)
    # the case exercises what it is named for
    if case == "two_edges":
        assert sum(x[3]["edges"] >= 2 for x in full) >= 30
    if case == "negative_pixels":
        assert sum(x[3]["neg"] for x in full) > 500
    if case == "frustum":
        assert sum(x[3]["steps"] < n_steps for x in got) > 100
    hit = np.array([x[0] for x in got])
    idx = np.array([x[1] for x in got], np.int32)
    t = np.array([x[2] for x in got], F)
    np.testing.assert_array_equal(hit, ref.hit.numpy())
    np.testing.assert_array_equal(idx, ref.idx.numpy())
    np.testing.assert_allclose(t, ref.t.numpy(), atol=1e-6)
    if not shadow_only:
        assert 20 < hit.sum() < n_rays - 20 or case == "negative_pixels"


def test_shift_equals_division_under_the_clamp():
    """A shift floors, C's division truncates, the reference floors: below
    zero all three land on the clamp's 0, from zero up they are equal."""
    for f in (1, 2, 4, 8, 16):
        s = f.bit_length() - 1
        for tw in (1, 8, 32):
            for x in range(-3 * f * tw, 3 * f * tw):
                want = _clamp(x // f, 0, tw - 1)
                assert _clamp(x >> s, 0, tw - 1) == want
                assert _clamp(int(x / f), 0, tw - 1) == want


def test_march_factor_must_be_power_of_two():
    with pytest.raises(ValueError):
        mk._log2_exact(3, "mip_f")
    assert [mk._log2_exact(f, "f") for f in (1, 2, 16)] == [0, 1, 4]


def test_origin_rows_of_a_broadcast():
    base = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    rows = mk._origin_rows(base.expand(4, 5, 3))
    assert rows.shape == (5, 3) and rows.data_ptr() == base.data_ptr()
    full = base.expand(4, 5, 3).contiguous()
    assert mk._origin_rows(full).shape == (20, 3)
    assert mk._origin_rows(base[None]).shape == (5, 3)
