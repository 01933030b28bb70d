"""The plain reference of the G-buffer path tracer: the trace (marches,
envmap sampling), the fused per-bounce shade and, by autograd of the plain
shade, its adjoint, in plain PyTorch on whatever device its inputs live.

It follows the estimator the program computes, draw for draw: the same
threefry keys and streams, the same record precisions (bf16 directions,
pdfs and taps, f16 normals, bf16 replayed material rows, bf16-rounded
material-adjoint contributions), and the same chunks and groups. It is
uncompacted: a compacted trace moves the same live rays through gathers
and returns them by scatter-adds, so its image is this one up to the
order of float additions. The kernels it stands in for are worked out
again from their plain definitions: the two-level march (A), the envmap
CDF sample and pdf (D, D′), the bilinear fetch (E), the bounce (B) and,
through autograd, B′ and the scatter-add adjoints (C′).

``dtype`` is the precision of the per-vertex shading arithmetic (the
bounce's BSDF evaluations, MIS weights, fetches and throughput update);
float32 is the configuration's, bfloat16 the control's. Geometry,
sampling and accumulation stay float32.

Nothing here imports the program: it is written from the inputs the
benchmark hands it (depth, maps, envmap, keys).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from perfbench.reference import rng

PI = math.pi
FOV_DEG = 35.0
# marches: fractions of the scene scale, steps, thickness
T_MIN_FRAC, T_MAX_FRAC, BIAS_FRAC = 2e-3, 3.0, 4e-3
GRAZING_COS = 0.105
R2_G = (0.7548776662466927, 0.5698402909980532)
PHI_1 = 0.6180339887498949


class Cfg(NamedTuple):
    spp: int = 64
    chunk: int = 8
    max_depth: int = 4
    march_steps: int = 24
    shadow_steps: int = 16
    fine_steps: int = 6
    shadow_fine_steps: int = 2
    film_jitter: float = 0.0
    interval_frac: float = 0.05
    replay_blob: bool = True


class Cam(NamedTuple):
    height: int
    width: int

    @property
    def focal(self) -> float:
        return 0.5 * self.width / math.tan(0.5 * math.radians(FOV_DEG))

    @property
    def cx(self) -> float:
        return 0.5 * self.width

    @property
    def cy(self) -> float:
        return 0.5 * self.height

    def project(self, p):
        inv_z = 1.0 / torch.clamp_min(-p[..., 2], 1e-6)
        u = self.cx + self.focal * p[..., 0] * inv_z - 0.5
        v = self.cy - self.focal * p[..., 1] * inv_z - 0.5
        return torch.stack([u, v], dim=-1)


class Geo(NamedTuple):
    position: torch.Tensor
    normal_geo: torch.Tensor
    dist: torch.Tensor
    wo: torch.Tensor
    valid: torch.Tensor


def norm(v, keepdim: bool = True):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def normalize9(v):
    return v / torch.clamp_min(norm(v), 1e-9)


# ------------------------------------------------------------- geometry

def geometry(depth, cam: Cam) -> Geo:
    """The G-buffer of a depth map (H, W), mirrored as 2·max(d) − d."""
    depth = depth.to(torch.float32)
    dist = 2.0 * depth.max() - depth
    valid = dist > 1e-6
    dist = torch.where(valid, dist, torch.zeros_like(dist))
    dev = dist.device
    v = torch.arange(cam.height, dtype=torch.float32, device=dev) + 0.5
    u = torch.arange(cam.width, dtype=torch.float32, device=dev) + 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dirs = torch.stack([(uu - cam.cx) / cam.focal, -(vv - cam.cy) / cam.focal,
                        -torch.ones_like(uu)], dim=-1)
    pos = dirs * dist[..., None]
    ppad = torch.nn.functional.pad(pos.permute(2, 0, 1)[None], (1, 1, 1, 1),
                                   mode="replicate")[0].permute(1, 2, 0)
    dx = ppad[1:-1, 2:] - ppad[1:-1, :-2]
    dy = ppad[2:, 1:-1] - ppad[:-2, 1:-1]
    n = torch.linalg.cross(dy, dx)
    n = n / torch.clamp_min(norm(n), 1e-12)
    n = torch.where(torch.sum(n * -pos, dim=-1, keepdim=True) < 0.0, -n, n)
    wo = -pos / torch.clamp_min(norm(pos), 1e-9)
    return Geo(pos, n, dist, wo, valid)


class Tables(NamedTuple):
    dist: torch.Tensor
    valid: torch.Tensor
    mip: torch.Tensor
    fine: torch.Tensor
    mip_f: int
    fine_f: int


def march_tables(geo: Geo) -> Tables:
    """Min-depth mip (≤ 1024 texels) and mean-depth table (≤ 4096) of the
    depth minus its near-grazing pixels."""
    h, w = geo.dist.shape
    cos_v = torch.abs(torch.sum(geo.normal_geo * geo.wo, dim=-1))
    valid = geo.valid & (cos_v > GRAZING_COS)
    dist = geo.dist
    mip_f = 1
    while (h // mip_f) * (w // mip_f) > 1024:
        mip_f *= 2
    fine_f = 1
    while (h // fine_f) * (w // fine_f) > 4096:
        fine_f *= 2
    d = torch.where(valid, dist, 1.0e30)
    mip = d.reshape(h // mip_f, mip_f, w // mip_f, mip_f).amin((1, 3))
    if fine_f == 1:
        fine = d
    else:
        vv = valid.reshape(h // fine_f, fine_f, w // fine_f, fine_f)
        dd = torch.where(valid, dist, 0.0).reshape(
            h // fine_f, fine_f, w // fine_f, fine_f)
        cnt = vv.sum((1, 3))
        fine = torch.where(cnt > 0, dd.sum((1, 3)) / torch.clamp_min(cnt, 1),
                           1.0e30)
    return Tables(dist, valid, mip, fine, mip_f, fine_f)


def _ipow(x, n: int):
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


def march(cam: Cam, tab: Tables, origin, direction, n_steps: int,
          fine_steps: int, interval_frac: float, shadow_only: bool = False):
    """Two-level screen-space march: an exponential coarse scan over the
    min-depth mip (start cell excluded, the first two rising-edge
    intervals kept), fine steps against the mean-depth table, the
    thickness test. Returns (hit, idx int32)."""
    dist_map, valid_map = tab.dist, tab.valid
    scene_scale = torch.clamp_min(
        torch.max(torch.where(valid_map, dist_map, 0.0)), 1e-6)
    t_lo = T_MIN_FRAC * scene_scale
    ratio = ((T_MAX_FRAC * scene_scale) / t_lo) ** (1.0 / max(n_steps - 1, 1))
    h, w = dist_map.shape
    mh, mw = tab.mip.shape
    fh, fw = tab.fine.shape
    mip_flat = tab.mip.reshape(-1)
    fine_flat = tab.fine.reshape(-1)
    batch = torch.broadcast_shapes(origin.shape[:-1], direction.shape[:-1])
    dev = direction.device

    def project(q):
        uv = cam.project(q)
        ui = torch.floor(uv[..., 0] + 0.5).to(torch.int32)
        vi = torch.floor(uv[..., 1] + 0.5).to(torch.int32)
        return ui, vi, (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)

    def cell(ui, vi, f, ch, cw):
        return (torch.clamp(_fdiv(vi, f), 0, ch - 1) * cw
                + torch.clamp(_fdiv(ui, f), 0, cw - 1))

    ui0, vi0, _ = project(origin)
    start_cell = cell(ui0, vi0, tab.mip_f, mh, mw)
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
        mi = cell(ui, vi, tab.mip_f, mh, mw)
        min_d = mip_flat[mi.long()]
        cand = inside & (ray_d > min_d * (1.0 - BIAS_FRAC)) \
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
        return found, torch.zeros(batch, dtype=torch.int32, device=dev)

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
            surf_d = fine_flat[cell(ui, vi, tab.fine_f, fh, fw).long()]
            ok = inside & (surf_d < 1.0e29)
            excess = ray_d - surf_d - BIAS_FRAC * surf_d
            crossing = ok & (excess > 0.0) & gate & ~hit
            t_hit = torch.where(crossing, t, t_hit)
            idx_hit = torch.where(crossing, idx, idx_hit)
            excess_hit = torch.where(crossing, excess, excess_hit)
            hit = hit | crossing
    q = origin + t_hit[..., None] * direction
    local = torch.clamp_min(-q[..., 2], 1e-6)
    hit = hit & (excess_hit < interval_frac * local)
    return hit, idx_hit.to(torch.int32)


# --------------------------------------------------------------- envmap

def dir_to_uv(d, h: int, w: int):
    phi = torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * PI)
    u = (phi - torch.floor(phi)) * w
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    return u, theta / PI * h


def uv_to_dir(u, v, h: int, w: int):
    phi = 2.0 * PI * u / w
    theta = PI * v / h
    st = torch.sin(theta)
    return torch.stack([st * torch.sin(phi), torch.cos(theta),
                        -st * torch.cos(phi)], dim=-1)


def bilinear_coords(d, h: int, w: int):
    u, v = dir_to_uv(d, h, w)
    uf, vf = u - 0.5, v - 0.5
    u0, v0 = torch.floor(uf), torch.floor(vf)
    return (torch.remainder(u0.to(torch.int32), w),
            torch.clamp(v0.to(torch.int32), 0, h - 1), uf - u0, vf - v0)


def lookup(env, u0, v0, du, dv):
    """Bilinear fetch (..., 3) at tap coords; differentiable in env."""
    h, w = env.shape[0], env.shape[1]
    flat = env.reshape(h * w, 3)
    u0 = u0.long()
    v0 = v0.long()
    u1 = torch.where(u0 + 1 >= w, 0, u0 + 1)
    v1 = torch.clamp_max(v0 + 1, h - 1)
    du = du[..., None]
    dv = dv[..., None]
    acc = (1.0 - du) * (1.0 - dv) * flat[v0 * w + u0]
    acc = acc + du * (1.0 - dv) * flat[v0 * w + u1]
    acc = acc + (1.0 - du) * dv * flat[v1 * w + u0]
    return acc + du * dv * flat[v1 * w + u1]


class Sampler(NamedTuple):
    c_cdf: torch.Tensor
    m_cdf: torch.Tensor
    c_pdf: torch.Tensor
    m_pdf: torch.Tensor


def build_sampler(env) -> Sampler:
    """Sin-weighted luminance CDFs, each texel floored at 1% of the mean."""
    h = env.shape[0]
    rows01 = (torch.arange(h, dtype=env.dtype, device=env.device) + 0.5) / h
    lum = 0.299 * env[..., 0] + 0.587 * env[..., 1] + 0.114 * env[..., 2]
    lum_sin = lum * torch.sin(PI * rows01)[:, None]
    lum_sin = torch.maximum(lum_sin, 0.01 * torch.mean(lum_sin) + 1e-12)
    c_sum = torch.cumsum(lum_sin, dim=1)
    row_tot = c_sum[:, -1:]
    m_sum = torch.cumsum(row_tot[:, 0], dim=0)
    return Sampler(c_sum / row_tot, m_sum / m_sum[-1], lum_sin / row_tot,
                   row_tot[:, 0] / m_sum[-1])


def _interp_cdf(at, prev, x):
    return torch.clamp((x - prev) / torch.clamp_min(at - prev, 1e-12),
                       0.0, 1.0)


def env_sample(smp: Sampler, u2):
    """Inverse-CDF direction (..., 3) and solid-angle pdf (..., 1)."""
    h, w = smp.c_cdf.shape
    x0, x1 = u2[..., 0], u2[..., 1]
    v_idx = torch.clamp(torch.sum(smp.m_cdf < x0[..., None], -1), 0, h - 1)
    m_prev = torch.cat([smp.m_cdf.new_zeros(1), smp.m_cdf[:-1]])
    dv = _interp_cdf(smp.m_cdf[v_idx], m_prev[v_idx], x0)
    v = v_idx.to(torch.float32) + dv
    row_cdf = smp.c_cdf[v_idx]
    u_idx = torch.clamp(torch.sum(row_cdf < x1[..., None], -1), 0, w - 1)
    at_c = torch.gather(row_cdf, -1, u_idx[..., None])[..., 0]
    prev_c = torch.where(
        u_idx > 0, torch.gather(row_cdf, -1, torch.clamp_min(
            u_idx - 1, 0)[..., None])[..., 0], 0.0)
    u = u_idx.to(torch.float32) + _interp_cdf(at_c, prev_c, x1)
    sin_theta = torch.clamp_min(torch.sin(v * PI / h), 1e-6)
    pdf = (h * w) * (smp.c_pdf[v_idx, u_idx] * smp.m_pdf[v_idx]) \
        / (2.0 * PI * PI * sin_theta)
    return uv_to_dir(u, v, h, w), pdf[..., None]


def env_pdf(smp: Sampler, d):
    h, w = smp.c_pdf.shape
    u, v = dir_to_uv(d, h, w)
    ui = torch.clamp(u.to(torch.int32), 0, w - 1).long()
    vi = torch.clamp(v.to(torch.int32), 0, h - 1).long()
    sin_theta = torch.clamp_min(torch.sin(torch.arccos(
        torch.clamp(d[..., 1], -1.0, 1.0))), 1e-6)
    return ((h * w) * (smp.c_pdf[vi, ui] * smp.m_pdf[vi])
            / (2.0 * PI * PI * sin_theta))[..., None]


# --------------------------------------------------------------- sampling

def pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def _frame(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def _to_world(local, n):
    t, b = _frame(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def sample_dirs(u1, u2, wo, n, rough):
    """50/50 mixture of a cosine-hemisphere and a GGX half-vector lobe."""
    sin_t = torch.sqrt(torch.clamp(u2[..., 0], 0.0, 1.0))
    cos_t = torch.sqrt(torch.clamp(1.0 - u2[..., 0], 0.0, 1.0))
    phi = 2.0 * PI * u2[..., 1]
    wi_d = _to_world(torch.stack([sin_t * torch.cos(phi),
                                  sin_t * torch.sin(phi), cos_t], -1), n)
    alpha = (rough * rough)[..., 0]
    a2 = alpha * alpha
    cos_s = torch.sqrt(torch.clamp(
        (1.0 - u2[..., 0]) / (u2[..., 0] * (a2 - 1.0) + 1.0), 0.0, 1.0))
    sin_s = torch.sqrt(torch.clamp(1.0 - cos_s * cos_s, 0.0, 1.0))
    wh = _to_world(torch.stack([sin_s * torch.cos(phi), sin_s * torch.sin(phi),
                                cos_s], -1), n)
    wi = 2.0 * torch.sum(wo * wh, -1, keepdim=True) * wh - wo
    wi = torch.nan_to_num(wi)
    wi_s = wi / torch.clamp_min(norm(wi), 1e-12)
    return torch.where((u1 > 0.5)[..., None], wi_d, wi_s)


def stream(key, s: int, n: int, dims: int, dev):
    """Per-pixel Cranley-Patterson rotated rank-1 lattice (s, n, dims)."""
    g = torch.tensor(R2_G[:dims] if dims >= 2 else (PHI_1,),
                     dtype=torch.float32, device=dev)
    t = torch.arange(s, dtype=torch.float32, device=dev)[:, None, None]
    return torch.fmod(t * g + rng.uniform(key, (1, n, dims), dev), 1.0)


def primary(key, cfg: Cfg, cam: Cam, geo: Geo, s: int):
    """Jittered primary vertex: bilinear validity-weighted geometry at the
    film position. (nrm_geo, pos, wo, valid0), each (s, n, ...)."""
    h, w = geo.dist.shape
    n = h * w
    dev = geo.dist.device
    r = min(cfg.film_jitter, 0.5)
    jit = (stream(rng.fold_in(key, 991), s, n, 2, dev) * 2.0 - 1.0) * r
    base = torch.arange(n, dtype=torch.int32, device=dev)
    ub, vb = base % w, base // w
    cu = ub.to(torch.float32) + 0.5 + jit[..., 0]
    cv = vb.to(torch.float32) + 0.5 + jit[..., 1]
    g5 = torch.cat([geo.dist[..., None], geo.normal_geo,
                    geo.valid[..., None].to(torch.float32)], dim=-1)
    pad = torch.nn.functional.pad(g5.permute(2, 0, 1)[None], (1, 1, 1, 1),
                                  mode="replicate")[0].permute(1, 2, 0)
    pad = pad.reshape(-1, 5)
    fu, fv = cu - 0.5, cv - 0.5
    u0, v0 = torch.floor(fu), torch.floor(fv)
    wu, wv = (fu - u0)[..., None], (fv - v0)[..., None]
    du0 = torch.clamp(u0.to(torch.int32) - ub, -1, 0)
    dv0 = torch.clamp(v0.to(torch.int32) - vb, -1, 0)

    def tap(dv, du, wgt):
        g = pad[((vb + 1 + dv) * (w + 2) + (ub + 1 + du)).long()]
        ok = g[..., 4:5]
        return g * (wgt * ok), wgt * ok

    t00, w00 = tap(dv0, du0, (1.0 - wu) * (1.0 - wv))
    t01, w01 = tap(dv0, du0 + 1, wu * (1.0 - wv))
    t10, w10 = tap(dv0 + 1, du0, (1.0 - wu) * wv)
    t11, w11 = tap(dv0 + 1, du0 + 1, wu * wv)
    wsum = w00 + w01 + w10 + w11
    g = (t00 + t01 + t10 + t11) / torch.clamp_min(wsum, 1e-9)
    x = (cu - cam.cx) / cam.focal
    y = -(cv - cam.cy) / cam.focal
    d = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    return (normalize9(g[..., 1:4]), d * g[..., 0][..., None],
            -d / torch.clamp_min(norm(d), 1e-9), wsum[..., 0] > 1e-6)


def pack(albedo, rough, metal, normal):
    n = albedo.shape[0] * albedo.shape[1]
    return torch.cat([albedo.reshape(n, 3), rough.reshape(n, 1),
                      metal.reshape(n, 1), normal.reshape(n, 3)], dim=-1)


# ------------------------------------------------------------------ trace

class Bounce(NamedTuple):
    hit: torch.Tensor     # (s, n) bool: the lobe ray hit the surface
    idx: torch.Tensor     # (s, n) int32 pixel it hit
    blob: torch.Tensor    # replayed bf16 material rows (b > 0) or None
    nrm: torch.Tensor     # f16 shading normal
    aux: torch.Tensor     # bf16 win(3) | gate_nee | gate_miss
    recb: torch.Tensor    # bf16 pdf_e | pdf_at | wi_e(3) | uvf(4) | uvi(4)


@torch.no_grad()
def trace_chunk(key, cfg: Cfg, cam: Cam, geo: Geo, tab: Tables, table,
                env):
    """The decision pass of one chunk of ``cfg.chunk`` samples a pixel:
    every draw and both marches of each bounce, as records."""
    h, w = geo.dist.shape
    n = h * w
    s = cfg.chunk
    dev = geo.dist.device
    table = table.detach()
    env = env.detach()
    smp = build_sampler(env)
    eh, ew = env.shape[0], env.shape[1]
    nrm_flat = geo.normal_geo.reshape(n, 3)
    mdist = tab.dist.reshape(n)
    dist_hi = mdist.to(torch.bfloat16).to(torch.float32)
    combo = torch.cat([table, dist_hi[:, None], (mdist - dist_hi)[:, None],
                       nrm_flat], dim=-1)
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(s, n)
    wo = geo.wo.reshape(n, 3).expand(s, n, 3)
    alive = geo.valid.reshape(n).expand(s, n)
    recs = []
    for b in range(cfg.max_depth - 1):
        k_lobe, k_uv, k_nee = rng.split(rng.fold_in(key, b), 3)
        rec_blob = None
        if b == 0 and cfg.film_jitter > 0.0:
            nrm, pos, wo, valid0 = primary(key, cfg, cam, geo, s)
            alive = alive & valid0
            blob = table
        elif b == 0:
            blob = table
            nrm = nrm_flat
            pos = geo.position.reshape(n, 3).expand(s, n, 3)
        else:
            f = combo[idx.long()]
            blob = f[..., :8]
            d = f[..., 8] + f[..., 9]
            uu = (idx % w).to(torch.float32) + 0.5
            vv = (idx // w).to(torch.float32) + 0.5
            pos = torch.stack([(uu - cam.cx) / cam.focal,
                               -(vv - cam.cy) / cam.focal,
                               -torch.ones_like(uu)], -1) * d[..., None]
            nrm = f[..., 10:13]
            if cfg.replay_blob:
                rec_blob = blob[..., :5].to(torch.bfloat16)
        u1 = stream(k_lobe, s, n, 1, dev)
        u2 = stream(k_uv, s, n, 2, dev)
        u_nee = stream(k_nee, s, n, 2, dev)
        wi = sample_dirs(u1[..., 0], u2, wo, nrm, blob[..., 3:4])
        pos = pos.expand(wi.shape)
        wi_e, pdf_e = env_sample(smp, u_nee)
        hit, hit_idx = march(cam, tab, pos, wi, cfg.march_steps,
                             cfg.fine_steps, cfg.interval_frac)
        shadowed, _ = march(cam, tab, pos, wi_e.expand(wi.shape),
                            cfg.shadow_steps, max(cfg.shadow_fine_steps, 1),
                            cfg.interval_frac, cfg.shadow_fine_steps == 0)
        uv_e = bilinear_coords(wi_e, eh, ew)
        uv_b = bilinear_coords(wi, eh, ew)
        uvi = torch.stack([uv_e[0], uv_e[1], uv_b[0], uv_b[1]], -1).to(
            torch.int16)
        uvf = torch.stack([uv_e[2], uv_e[3], uv_b[2], uv_b[3]], -1).to(
            torch.bfloat16)
        win = normalize9(wi.to(torch.bfloat16).to(torch.float32))
        gate_nee = (alive & ~shadowed).to(torch.float32)
        gate_miss = (alive & ~hit).to(torch.float32)
        aux = torch.cat([win, gate_nee[..., None], gate_miss[..., None]],
                        -1).to(torch.bfloat16)
        recb = torch.cat([pdf_e.to(torch.bfloat16),
                          env_pdf(smp, wi).to(torch.bfloat16),
                          wi_e.to(torch.bfloat16), uvf,
                          uvi.to(torch.bfloat16)], -1)
        recs.append(Bounce(hit, hit_idx, rec_blob,
                           nrm.expand(wi.shape).to(torch.float16), aux, recb))
        idx = hit_idx
        wo = -wi
        alive = alive & hit
    return recs


# ------------------------------------------------------------------ shade

class _Replay(torch.autograd.Function):
    """Rows the trace fetched: forward the recorded rows, backward their
    cotangent, rounded to bf16 a contribution, summed into the table."""

    @staticmethod
    def forward(ctx, table, idx, primal):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return primal.clone()

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        n, k = ctx.shape
        c = torch.nn.functional.pad(cot, (0, k - cot.shape[-1]))
        c = c.reshape(-1, k).to(torch.bfloat16).to(torch.float32)
        g = torch.zeros((n, k), dtype=torch.float32, device=cot.device)
        g.index_add_(0, idx.reshape(-1).long(), c)
        return g, None, None


class _Refetch(torch.autograd.Function):
    """Rows fetched again (no replay): the same bf16-rounded adjoint."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx.long()]

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        n, k = ctx.shape
        c = cot.reshape(-1, k).to(torch.bfloat16).to(torch.float32)
        g = torch.zeros((n, k), dtype=torch.float32, device=cot.device)
        g.index_add_(0, idx.reshape(-1).long(), c)
        return g, None


def _disney(a, rough, metal, wi, wo, n):
    """Disney diffuse + GGX metal BRDF with NoL folded in, and the
    mixture pdf, on (M, ...) planes."""
    def dot(x, y):
        return (x[:, 0] * y[:, 0] + x[:, 1] * y[:, 1]) + x[:, 2] * y[:, 2]
    hv = wi + wo
    hv = hv / torch.clamp_min(torch.sqrt(dot(hv, hv)), 1e-12)[:, None]
    no_l = torch.clamp_min(dot(n, wi), 0.0)
    no_v = torch.clamp_min(dot(n, wo), 0.0)
    vo_h = torch.clamp_min(dot(wo, hv), 0.0)
    no_h = torch.clamp_min(dot(n, hv), 0.0)
    alpha = rough * rough
    alpha2 = alpha * alpha
    den = no_h * no_h * (alpha2 - 1.0) + 1.0 + 1e-6
    d = alpha2 / (PI * den * den)
    pdf = 0.5 * (d / (4.0 * torch.clamp_min(vo_h, 1e-6)) * no_h) \
        + 0.5 * (no_l / PI)
    one_m = 1.0 - metal
    f_d90 = 0.5 + 2.0 * vo_h * vo_h * rough
    f_out = 1.0 + (f_d90 - 1.0) * pow5(1.0 - no_v)
    f_in = 1.0 + (f_d90 - 1.0) * pow5(1.0 - no_l)
    diff_s = one_m / PI * f_out * f_in * no_l
    r1 = rough + 1.0
    k = r1 * r1 / 8.0
    g = 1.0 / ((no_l * (1.0 - k) + k + 1e-6) * (no_v * (1.0 - k) + k + 1e-6))
    dg4 = d * g / 4.0 * no_l
    c0 = one_m[:, None] * 0.04 + metal[:, None] * a
    fm = c0 + (1.0 - c0) * pow5(1.0 - vo_h)[:, None]
    return a * diff_s[:, None] + dg4[:, None] * fm, pdf


def bounce(env, blob, thr, nrmf, auxf, recb, dtype=torch.float32):
    """One path vertex: (throughput', Δradiance), each (M, 3) float32.
    Differentiable in env, blob and thr."""
    n = nrmf.to(dtype)
    a_ = auxf.to(dtype)
    r = recb.to(torch.float32)
    wo, win = a_[:, 0:3], a_[:, 3:6]
    g_nee, g_miss = a_[:, 6] > 0.0, a_[:, 7] > 0.0
    pdf_e, pdf_at = r[:, 0].to(dtype), r[:, 1].to(dtype)
    wie, uvf, uvi = r[:, 2:5].to(dtype), r[:, 5:9], r[:, 9:13].to(torch.int64)
    envd = env.to(dtype)
    le = lookup(envd, uvi[:, 0], uvi[:, 1], uvf[:, 0].to(dtype),
                uvf[:, 1].to(dtype))
    lm = lookup(envd, uvi[:, 2], uvi[:, 3], uvf[:, 2].to(dtype),
                uvf[:, 3].to(dtype))
    blob = blob.to(dtype)
    thr = thr.to(dtype)
    a, rough, metal = blob[:, 0:3], blob[:, 3], blob[:, 4]
    fe, pdf_be = _disney(a, rough, metal, wie, wo, n)
    w_mis = pdf_e / (pdf_e + pdf_be.detach() + 1e-9)
    s_nee = (w_mis / (pdf_e + 1e-9))[:, None]
    fb, pdf_b = _disney(a, rough, metal, win, wo, n)
    pdf_b = pdf_b.detach()
    ok = (pdf_b > 1e-6)[:, None]
    wgt = torch.nan_to_num(torch.where(ok, fb * (1.0 / (pdf_b + 1e-6))[:, None],
                                       0.0), nan=0.0, posinf=0.0, neginf=0.0)
    w_mis_b = (pdf_b / (pdf_b + pdf_at + 1e-9))[:, None]
    cn = torch.where(g_nee[:, None], thr * fe * s_nee * le, 0.0)
    cm = torch.where(g_miss[:, None], thr * wgt * w_mis_b * lm, 0.0)
    return (thr * wgt).to(torch.float32), (cn + cm).to(torch.float32)


def shade_chunk(key, recs, cfg: Cfg, cam: Cam, geo: Geo, table, env,
                dtype=torch.float32):
    """The replay of one chunk: its image (H, W, 3), differentiable in the
    material table (N, 8) and the envmap."""
    h, w = geo.dist.shape
    n = h * w
    s = cfg.chunk
    dev = geo.dist.device
    valid = geo.valid.reshape(n)
    wo = geo.wo.reshape(n, 3).expand(s, n, 3)
    thr = torch.ones((s, n, 3), dtype=torch.float32, device=dev)
    sky = lookup(env, *bilinear_coords(-geo.wo.reshape(n, 3), env.shape[0],
                                       env.shape[1]))
    rad = torch.where(valid[None, :, None], 0.0, sky[None]).expand(s, n, 3)
    idx = None
    for b in range(cfg.max_depth - 1):
        rec = recs[b]
        if b == 0:
            if cfg.film_jitter > 0.0:
                _, _, wo, _ = primary(key, cfg, cam, geo, s)
            blob = table
            wo_d = wo
        else:
            if rec.blob is not None:
                blob = _Replay.apply(table, idx, rec.blob.to(torch.float32))
            else:
                blob = _Refetch.apply(table, idx)
            wo_d = -normalize9(recs[b - 1].aux[..., 0:3].to(torch.float32))
        tgt = rec.aux.shape[:-1]
        auxf = torch.cat([wo_d.expand(tgt + (3,)).to(torch.bfloat16),
                          rec.aux], -1)
        thr_o, contrib = bounce(env, blob[..., :5].expand(tgt + (5,))
                                .reshape(-1, 5), thr.reshape(-1, 3),
                                rec.nrm.reshape(-1, 3), auxf.reshape(-1, 8),
                                rec.recb.reshape(-1, 13), dtype)
        thr = thr_o.reshape(s, n, 3)
        rad = rad + contrib.reshape(s, n, 3)
        idx = rec.idx
    img = torch.mean(rad, dim=0)
    return torch.nan_to_num(img, nan=0.0, posinf=0.0,
                            neginf=0.0).reshape(h, w, 3)


def chunk_keys(key, cfg: Cfg, n_groups: int):
    """[(group, chunk key)] as the program splits a step's key: into
    groups, then each group's key into its chunks."""
    n_chunks = max(cfg.spp // n_groups // cfg.chunk, 1)
    out = []
    gkeys = rng.split(key, n_groups)
    for g in range(n_groups):
        ck = rng.split(gkeys[g], n_chunks)
        out += [ck[c] for c in range(n_chunks)]
    return out


def alter(img):
    """The planted fault "an answer altered where it is produced": the
    first film row of a chunk's image doubled."""
    return torch.cat([img[:1] * 2.0, img[1:]])


def render(key, cfg: Cfg, cam: Cam, geo: Geo, table, env,
           dtype=torch.float32, chunks=None, fault=None):
    """The mean of the chunk images of one render (one group), no
    gradient. ``chunks``: the chunk indices to render (all by default)."""
    tab = march_tables(geo)
    keys = rng.split(key, max(cfg.spp // cfg.chunk, 1))
    use = range(len(keys)) if chunks is None else chunks
    total = None
    with torch.no_grad():
        for c in use:
            recs = trace_chunk(keys[c], cfg, cam, geo, tab, table, env)
            img = shade_chunk(keys[c], recs, cfg, cam, geo, table, env, dtype)
            if fault == "altered":
                img = alter(img)
            total = img if total is None else total + img
    return total / len(use)


# --------------------------------------------------------------- denoise

_K1 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


@torch.no_grad()
def denoise(color, albedo, normal, n_passes: int = 3, sigma_color=0.25,
            sigma_albedo=0.15, sigma_normal=0.3):
    """Edge-aware à-trous wavelet filter: 3 passes of 5×5 dilated taps
    (wrapping at the borders) with range weights on colour, albedo and
    normal."""
    out = color
    for p in range(n_passes):
        step = 1 << p
        acc = torch.zeros_like(out)
        wacc = torch.zeros_like(out[..., :1])
        for i in range(5):
            for j in range(5):
                sh = ((i - 2) * step, (j - 2) * step)
                c = torch.roll(out, sh, dims=(0, 1))
                wgt = (_K1[i] * _K1[j]) * torch.exp(
                    -torch.sum((c - out) ** 2, -1) / (2 * sigma_color ** 2))
                wgt = wgt * torch.exp(-torch.sum(
                    (torch.roll(albedo, sh, dims=(0, 1)) - albedo) ** 2, -1)
                    / (2 * sigma_albedo ** 2))
                wgt = wgt * torch.exp(-torch.sum(
                    (torch.roll(normal, sh, dims=(0, 1)) - normal) ** 2, -1)
                    / (2 * sigma_normal ** 2))
                acc = acc + c * wgt[..., None]
                wacc = wacc + wgt[..., None]
        out = acc / torch.clamp_min(wacc, 1e-8)
    return out
