"""Screen-space marching against the depth heightfield (counterpart of
``materialist_tpu/render/screenspace.py``): ``march`` and ``occluded``,
the full-resolution march of ``march_impl="exact"`` (sequential or
step-parallel); the min-depth mip, the mean-depth fine table and the
two-level ``march_mip``, which is the plain version of the march kernels
(``ops/kernels/march.py``). ``march_mip``'s table reads go through
``lookup``: plain indexing by default, the table-lookup kernel
(``ops/kernels/gather.py``) for the "mip" march implementation.
Everything here runs without gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from materialist_tpu_torch.camera import Camera


class Hit(NamedTuple):
    hit: torch.Tensor      # (...,) bool
    idx: torch.Tensor      # (...,) int32 flat pixel index of the hit
    t: torch.Tensor        # (...,) ray parameter at the hit
    exited: torch.Tensor   # (...,) ray left the view frustum (envmap miss)


def _sample_heightfield(dist_flat, valid_flat, cam: Camera, q):
    """Depth-buffer fetch at the projection of world points q (..., 3).
    Returns (surface_dist, pixel_idx int32, inside_screen)."""
    uv = cam.project(q)
    ui = torch.floor(uv[..., 0] + 0.5).to(torch.int32)
    vi = torch.floor(uv[..., 1] + 0.5).to(torch.int32)
    inside = (ui >= 0) & (ui < cam.width) & (vi >= 0) & (vi < cam.height)
    idx = torch.clamp(vi, 0, cam.height - 1) * cam.width + torch.clamp(
        ui, 0, cam.width - 1)
    il = idx.long()
    return dist_flat[il], idx, inside & valid_flat[il]


@torch.no_grad()
def march(cam: Camera, dist_map, valid_map, origin, direction,
          n_steps: int = 24, n_refine: int = 5, t_min_frac: float = 2e-3,
          t_max_frac: float = 3.0, bias_frac: float = 4e-3,
          interval_frac: float = 2.0, vectorized: bool = False) -> Hit:
    """March rays from surface points through the full-resolution depth
    heightfield: ``n_steps`` exponential steps between ``t_min_frac`` and
    ``t_max_frac`` of the scene scale, ``n_refine`` bisection steps after
    the first crossing, and the thickness test (a crossing counts only if
    the refined depth excess is below ``interval_frac`` of the local
    distance). The step lengths are float32 tensors built from the scene
    scale by the JAX package's operations, in their order."""
    scene_scale = torch.clamp_min(torch.max(dist_map), 1e-6)
    t_lo = t_min_frac * scene_scale
    t_hi = t_max_frac * scene_scale
    ratio = (t_hi / t_lo) ** (1.0 / max(n_steps - 1, 1))
    dist_flat = dist_map.reshape(-1)
    valid_flat = valid_map.reshape(-1)
    if vectorized:
        return _march_vectorized(cam, dist_flat, valid_flat, origin,
                                 direction, n_steps, n_refine, t_lo, ratio,
                                 bias_frac, interval_frac)

    batch = torch.broadcast_shapes(origin.shape[:-1], direction.shape[:-1])
    dev = origin.device
    neg_inf = float("-inf")

    def ray_excess(t):
        """Positive: the ray point lies behind the surface at its pixel."""
        q = origin + t[..., None] * direction
        ray_d = -q[..., 2]
        surf_d, idx, ok = _sample_heightfield(dist_flat, valid_flat, cam, q)
        excess = torch.where(ok, ray_d - surf_d - bias_frac * surf_d, neg_inf)
        return excess, idx, ok, ray_d

    found = torch.zeros(batch, dtype=torch.bool, device=dev)
    exited = torch.zeros(batch, dtype=torch.bool, device=dev)
    t_before = t_lo.expand(batch)
    t_cross = torch.zeros(batch, dtype=torch.float32, device=dev)
    excess_cross = torch.full(batch, neg_inf, dtype=torch.float32, device=dev)
    for i in range(n_steps):
        t = (t_lo * _ipow(ratio, i)).expand(batch)
        excess, _, ok, ray_d = ray_excess(t)
        exited_now = (~ok) | (ray_d <= 0.0)
        crossing = (excess > 0.0) & ~found & ~exited
        t_cross = torch.where(crossing, t, t_cross)
        excess_cross = torch.where(crossing, excess, excess_cross)
        found = found | crossing
        exited = exited | (exited_now & ~found)
        t_before = torch.where(found | exited, t_before, t)

    lo = t_before
    hi = torch.where(found, t_cross, t_before)
    for _ in range(n_refine):
        mid = 0.5 * (lo + hi)
        excess, _, ok, _ = ray_excess(mid)
        behind = (excess > 0.0) & ok
        lo = torch.where(behind, lo, mid)
        hi = torch.where(behind, mid, hi)
    t_hit = torch.where(found, hi, t_cross)

    excess_hit, idx_hit, ok_hit, _ = ray_excess(t_hit)
    q = origin + t_hit[..., None] * direction
    local = torch.clamp_min(-q[..., 2], 1e-6)
    thin = torch.where(found, excess_hit, excess_cross) < interval_frac * local
    hit = found & thin & ok_hit
    return Hit(hit, idx_hit, t_hit, exited | ~hit)


def _march_vectorized(cam: Camera, dist_flat, valid_flat, origin, direction,
                      n_steps, n_refine, t_lo, ratio, bias_frac,
                      interval_frac) -> Hit:
    """Step-parallel marching: all K sample points in a few large
    operations (K on the trailing axis), the first crossing by an argmax
    (of integers: the first maximum is the first True)."""
    neg_inf = float("-inf")
    dev = origin.device

    def excess_at(t):
        """t: (..., K) → (excess, idx, ok, ray_d), all (..., K)."""
        q = origin[..., None, :] + t[..., :, None] * direction[..., None, :]
        ray_d = -q[..., 2]
        surf_d, idx, ok = _sample_heightfield(dist_flat, valid_flat, cam, q)
        excess = torch.where(ok, ray_d - surf_d - bias_frac * surf_d, neg_inf)
        return excess, idx, ok, ray_d

    def first_true(flags):
        return torch.argmax(flags.to(torch.int8), dim=-1, keepdim=True)

    def take(x, i):
        return torch.gather(x, -1, i)[..., 0]

    batch = torch.broadcast_shapes(origin.shape[:-1], direction.shape[:-1])
    k = torch.arange(n_steps, dtype=torch.float32, device=dev)
    ts = t_lo * ratio ** k                                  # (K,)
    t_b = ts.expand(batch + (n_steps,))
    excess, idx, ok, ray_d = excess_at(t_b)

    exited_step = (~ok) | (ray_d <= 0.0)
    ex_i = exited_step.to(torch.int32)
    exited_before = torch.cumsum(ex_i, dim=-1) - ex_i > 0
    crossed = (excess > 0.0) & ~exited_step & ~exited_before

    any_cross = torch.any(crossed, dim=-1)
    first = first_true(crossed)                             # (..., 1)
    t_cross = take(t_b, first)
    excess_cross = take(excess, first)
    t_before = torch.where(first[..., 0] > 0, t_cross / ratio, t_lo)

    if n_refine > 0:
        frac = (torch.arange(n_refine, dtype=torch.float32, device=dev)
                + 1.0) / n_refine
        t_ref = t_before[..., None] + (t_cross - t_before)[..., None] * frac
        e_r, idx_r, ok_r, _ = excess_at(t_ref)
        crossed_r = (e_r > 0.0) & ok_r
        pick = torch.where(torch.any(crossed_r, dim=-1, keepdim=True),
                           first_true(crossed_r), n_refine - 1)
        t_hit = take(t_ref, pick)
        idx_hit = take(idx_r, pick)
        e_hit = take(e_r, pick)
        ok_hit = take(ok_r, pick)
    else:
        t_hit = t_cross
        idx_hit = take(idx, first)
        e_hit = excess_cross
        ok_hit = take(ok, first)

    q = origin + t_hit[..., None] * direction
    local = torch.clamp_min(-q[..., 2], 1e-6)
    thin = e_hit < interval_frac * local
    hit = any_cross & thin & ok_hit & (e_hit > neg_inf)
    exited = torch.any(exited_step & ~exited_before, dim=-1) & ~hit
    return Hit(hit, idx_hit, t_hit, exited | ~hit)


def occluded(cam: Camera, dist_map, valid_map, origin, direction,
             n_steps: int = 16, **kw) -> torch.Tensor:
    """Boolean shadow query for NEE rays. A tight thickness bound
    (interval_frac < 1) needs the refined excess, so two refinement steps
    run; otherwise the march is coarse only."""
    n_refine = 2 if kw.get("interval_frac", 2.0) < 1.0 else 0
    return march(cam, dist_map, valid_map, origin, direction,
                 n_steps=n_steps, n_refine=n_refine, **kw).hit


def build_min_mip(dist_map, valid_map, factor: int = 4):
    """Min-depth mip with invalid texels excluded (large sentinel)."""
    h, w = dist_map.shape
    d = torch.where(valid_map, dist_map, 1.0e30)
    return d.reshape(h // factor, factor, w // factor, factor).amin((1, 3))


def build_fine_table(dist_map, valid_map, factor: int = 2):
    """factor×factor mean depth over valid texels (sentinel where none)."""
    if factor == 1:
        return torch.where(valid_map, dist_map, 1.0e30)
    h, w = dist_map.shape
    v = valid_map.reshape(h // factor, factor, w // factor, factor)
    d = torch.where(valid_map, dist_map, 0.0).reshape(
        h // factor, factor, w // factor, factor)
    cnt = v.sum((1, 3))
    mean = d.sum((1, 3)) / torch.clamp_min(cnt, 1)
    return torch.where(cnt > 0, mean, 1.0e30)


def _ipow(x, n: int):
    """x**n by binary exponentiation, the multiplication order of XLA's
    integer_pow."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def _fdiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def march_mip(cam: Camera, dist_map, valid_map, mip, origin, direction,
              n_steps: int = 24, fine_steps: int = 6,
              t_min_frac: float = 2e-3, t_max_frac: float = 3.0,
              bias_frac: float = 4e-3, interval_frac: float = 2.0,
              mip_factor: int = 4, shadow_only: bool = False,
              fine_table=None, fine_factor: int = 1, lookup=None) -> Hit:
    """Two-level march: exponential coarse scan over the min-depth mip
    (start cell excluded, first two rising-edge intervals kept), fine
    refinement against the mean-depth table, and the thickness test.
    ``lookup(table (H, W), flat int32 idx)`` reads both tables."""
    if lookup is None:
        def lookup(table, idx):
            return table.reshape(-1)[idx.long()]
    scene_scale = torch.clamp_min(
        torch.max(torch.where(valid_map, dist_map, 0.0)), 1e-6)
    t_lo = t_min_frac * scene_scale
    t_hi = t_max_frac * scene_scale
    ratio = (t_hi / t_lo) ** (1.0 / max(n_steps - 1, 1))

    h, w = dist_map.shape
    mh, mw = mip.shape
    batch = origin.shape[:-1]
    dev = origin.device
    if fine_table is None:
        fine_table = build_fine_table(dist_map, valid_map, fine_factor)
    fh, fw = fine_table.shape

    def project(q):
        uv = cam.project(q)
        ui = torch.floor(uv[..., 0] + 0.5).to(torch.int32)
        vi = torch.floor(uv[..., 1] + 0.5).to(torch.int32)
        inside = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        return ui, vi, inside

    ui0, vi0, _ = project(origin)
    start_cell = torch.clamp(_fdiv(vi0, mip_factor), 0, mh - 1) * mw \
        + torch.clamp(_fdiv(ui0, mip_factor), 0, mw - 1)

    prev_cand = torch.zeros(batch, dtype=torch.bool, device=dev)
    edge_cnt = torch.zeros(batch, dtype=torch.int32, device=dev)
    exited = torch.zeros(batch, dtype=torch.bool, device=dev)
    t_prev = torch.full(batch, 1.0, device=dev) * t_lo
    tb = [t_prev.clone(), t_prev.clone()]
    tc = [t_prev.clone(), t_prev.clone()]
    for i in range(n_steps):
        t = t_lo * _ipow(ratio, i)
        q = origin + t * direction
        ray_d = -q[..., 2]
        ui, vi, inside = project(q)
        mi = torch.clamp(_fdiv(vi, mip_factor), 0, mh - 1) * mw \
            + torch.clamp(_fdiv(ui, mip_factor), 0, mw - 1)
        min_d = lookup(mip, mi)
        cand = inside & (ray_d > min_d * (1.0 - bias_frac)) \
            & (ray_d > 0.0) & (mi != start_cell) & ~exited
        rising = cand & ~prev_cand
        for s in range(2):
            newk = rising & (edge_cnt == s)
            tb[s] = torch.where(newk, t_prev, tb[s])
            tc[s] = torch.where(newk, t, tc[s])
        edge_cnt = edge_cnt + rising.to(torch.int32)
        prev_cand = cand
        exited = exited | (((~inside) | (ray_d <= 0.0)) & (edge_cnt == 0))
        t_prev = torch.broadcast_to(t, batch)

    found = edge_cnt > 0
    if shadow_only:
        return Hit(found, torch.zeros(batch, dtype=torch.int32, device=dev),
                   tc[0], exited | ~found)

    hit = torch.zeros(batch, dtype=torch.bool, device=dev)
    t_hit = tc[0]
    idx_hit = torch.zeros(batch, dtype=torch.int32, device=dev)
    excess_hit = torch.zeros(batch, dtype=torch.float32, device=dev)
    frac = (torch.arange(fine_steps, dtype=torch.float32, device=dev)
            + 1.0) / fine_steps
    for s in range(2):
        lo_t = tb[s]
        hi_t = tc[s] * ratio
        gate = (edge_cnt > s) & ~hit
        for k in range(fine_steps):
            t = lo_t + (hi_t - lo_t) * frac[k]
            q = origin + t[..., None] * direction
            ray_d = -q[..., 2]
            ui, vi, inside = project(q)
            idx = torch.clamp(vi, 0, h - 1) * w + torch.clamp(ui, 0, w - 1)
            fidx = torch.clamp(_fdiv(vi, fine_factor), 0, fh - 1) * fw \
                + torch.clamp(_fdiv(ui, fine_factor), 0, fw - 1)
            surf_d = lookup(fine_table, fidx)
            ok = inside & (surf_d < 1.0e29)
            excess = ray_d - surf_d - bias_frac * surf_d
            crossing = ok & (excess > 0.0) & gate & ~hit
            t_hit = torch.where(crossing, t, t_hit)
            idx_hit = torch.where(crossing, idx, idx_hit)
            excess_hit = torch.where(crossing, excess, excess_hit)
            hit = hit | crossing

    q = origin + t_hit[..., None] * direction
    local = torch.clamp_min(-q[..., 2], 1e-6)
    hit = hit & (excess_hit < interval_frac * local)
    return Hit(hit, idx_hit.to(torch.int32), t_hit, exited | ~hit)
