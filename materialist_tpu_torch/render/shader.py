"""Differentiable Monte-Carlo G-buffer path tracer (counterpart of
``materialist_tpu/render/shader.py``).

Path-replay structure: ``trace_step_records`` resolves every sampling
decision and all visibility (the marches) without gradients into compact
per-chunk records; ``shade_from_records`` replays them and evaluates the
differentiable radiance. Primary visibility is the pixel grid, secondary
visibility is the screen-space march (kernels A/A′, or ``march_mip`` over
the table-lookup kernel F for ``march_impl="mip"``), the per-vertex shade
of the production configuration is the fused bounce (kernels B/B′), whose
records kernel H writes after the march, NEE samples come from kernel D
and pdfs from D′ (in H for the fused bounce), the sky from kernel E. With
``compact_caps`` the dead rays are dropped between bounces and the live
ones move through the row gather and scatter-add (kernels C/C′).

Sampling decisions, pdfs, MIS weights and geometry are detached; the
gradient reaches the material maps and the envmap only. The estimator's
draws come from the threefry keys of ``materialist_tpu_torch.rng`` and
are the JAX package's draws for the same key.

``march_impl="exact"`` marches the full-resolution depth map in plain
tensor code (``screenspace.march``), as the JAX package does outside any
kernel. A ``FilmSlice`` restricts the primary rays and the output to a
range of film rows (the px-sharded renders of ``parallel/sharding.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera, norm
from materialist_tpu_torch.ops import envmap as em
from materialist_tpu_torch.ops.kernels import march as mk
from materialist_tpu_torch.ops.kernels.envkernels import bounce_record
from materialist_tpu_torch.ops.kernels.gather import onehot_gather
from materialist_tpu_torch.ops.kernels.primary import primary_state
from materialist_tpu_torch.ops.kernels.rowops import (
    _f32_exact_join, _f32_exact_split, compact_sel, gather_coherent_diff,
    gather_rows_coherent, row_gather, scatter_add_coherent_into)
from materialist_tpu_torch.ops.kernels.shadebounce import shade_bounce_fused
from materialist_tpu_torch.render import bsdf as bsdf_mod
from materialist_tpu_torch.render import screenspace as ss
from materialist_tpu_torch.render.scene import GBuffer, Materials
from materialist_tpu_torch.utils import profiling as prof

# the stages of a chunk's trace and shade (utils/profiling.py: spans)
_TRACE_CHUNK = prof.span("trace.chunk")
_TRACE_BOUNCE = prof.Numbered("trace.bounce")
_TRACE_PRIMARY = prof.span("trace.primary")    # bounce 0's state
_TRACE_FETCH = prof.span("trace.fetch")        # the side table's row gather
_TRACE_DRAWS = prof.span("trace.draws")        # the estimator's streams
_TRACE_SAMPLE = prof.span("trace.sample")      # directions, pdfs, env taps
_TRACE_MARCH = prof.span("trace.march")
_TRACE_RECORDS = prof.span("trace.records")    # the bounce's stored layouts
_TRACE_COMPACT = prof.span("trace.compact")    # the live rays' partition
_SHADE_CHUNK = prof.span("shade.chunk")
_SHADE_BOUNCE = prof.Numbered("shade.bounce")
_SHADE_FETCH = prof.span("shade.fetch")        # the vertex's rows and wo
_SHADE_EVAL = prof.span("shade.eval")          # the bounce's radiance
_SHADE_FILM = prof.span("shade.film")          # onto the film, the mean


class RenderConfig(NamedTuple):
    """Static render parameters; fields and defaults of the JAX package."""
    spp: int = 64
    chunk: int = 8
    max_depth: int = 4
    use_mesh_normal: bool = True
    march_steps: int = 24
    shadow_steps: int = 16
    nee: bool = True
    sky_background: bool = True
    march_impl: str = "fused"
    mip_factor: int = 4
    fine_steps: int = 6
    shadow_fine_steps: int = 2
    fine_factor: int = 2
    film_jitter: float = 0.0
    march_vectorized: bool = False
    replay_blob: bool = True
    march_grazing_cos: float = 0.105
    lds: bool = True
    march_bg_fill: int = 0
    march_interval_frac: float = 0.05
    # wavefront compaction: per-secondary-bounce ray capacities as
    # fractions of the chunk's ray count, e.g. (0.5, 0.25) for max_depth
    # 4; live rays beyond a cap count as dead (size the caps with
    # probe_compact_caps). Empty: no compaction.
    compact_caps: tuple = ()


class BounceRecord(NamedTuple):
    """Trace record of one bounce. Fused-shade records carry ``nrm`` (f16
    shading normal), ``aux`` (bf16 win|gates) and ``recb`` (bf16
    pdfs|wi_e|uv taps); generic records carry the individual fields.
    ``extras`` = (sel, count, vertex idx, film position) says how a
    compacted bounce's arrays were formed from the previous bounce's."""
    shadowed: torch.Tensor
    hit: torch.Tensor
    idx: torch.Tensor
    blob: torch.Tensor = None
    nrm: torch.Tensor = None
    wi_e: torch.Tensor = None
    pdf_e: torch.Tensor = None
    pdf_at: torch.Tensor = None
    wi: torch.Tensor = None
    uvi: torch.Tensor = None
    uvf: torch.Tensor = None
    aux: torch.Tensor = None
    recb: torch.Tensor = None
    extras: tuple = None


class FilmSlice(NamedTuple):
    """Rows [row0, row0 + n_rows) of the film that a render call covers
    (px sharding). The G-buffer, the material table, the march tables and
    the compaction caps' fractions stay full-film: a secondary ray can
    march anywhere, and the 3×3 geometry taps at a slice's edge read the
    true neighbour rows. Only the primary rays and the output are
    restricted. The estimator's streams are drawn at the slice's own
    pixel count, as in the JAX package. ``None`` renders the whole film."""
    row0: int
    n_rows: int


def _film_base(film, h: int, w: int):
    """(pixel-id offset, local row count) of a FilmSlice or the full film."""
    if film is None:
        return 0, h
    if film.n_rows < 1 or film.row0 < 0 or film.row0 + film.n_rows > h:
        raise ValueError(f"{film} does not lie inside a film of {h} rows")
    return film.row0 * w, film.n_rows


def _check_cfg(cfg: RenderConfig) -> None:
    if cfg.march_impl not in ("fused", "mip", "exact"):
        raise ValueError(
            f"march_impl={cfg.march_impl!r}: expected 'fused', 'mip' or "
            "'exact'")


def _normalize9(v):
    return v / torch.clamp_min(norm(v), 1e-9)


def _march_valid(cfg: RenderConfig, gbuf: GBuffer):
    """Scene validity minus near-grazing pixels."""
    if cfg.march_grazing_cos <= 0.0:
        return gbuf.valid
    cos_v = torch.abs(torch.sum(gbuf.normal_geo * gbuf.wo, dim=-1))
    return gbuf.valid & (cos_v > cfg.march_grazing_cos)


def _max3x3(x):
    h, w = x.shape
    p = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    out = x
    for dv in (-1, 0, 1):
        for du in (-1, 0, 1):
            out = torch.maximum(out, p[1 + dv:1 + dv + h, 1 + du:1 + du + w])
    return out


def _march_geometry(cfg: RenderConfig, gbuf: GBuffer):
    """(dist, valid) the marches test against, with optional background
    fill of the grazing-masked bands."""
    march_ok = _march_valid(cfg, gbuf)
    dist = gbuf.dist.detach()
    if cfg.march_bg_fill <= 0:
        return dist, march_ok
    d = torch.where(march_ok, dist, -1.0)
    v = march_ok
    for _ in range(cfg.march_bg_fill):
        dn = _max3x3(d)
        fill = (~v) & gbuf.valid & (dn > 0.0)
        d = torch.where(fill, dn, d)
        v = v | fill
    return torch.where(v, d, dist), v


# the lattice generators by stream width: the golden ratio, the
# plastic-constant (R2) pair
_LATTICE_G = {1: (0.6180339887498949,),
              2: (0.7548776662466927, 0.5698402909980532)}


def _stream_uniform(cfg: RenderConfig, key, s: int, n_loc: int, dims: int,
                    device):
    """One estimator stream (s, n_loc, dims): per-pixel Cranley-Patterson
    rotated rank-1 lattices over the sample axis (cfg.lds) or i.i.d."""
    if not cfg.lds:
        return rng.uniform(key, (s, n_loc, dims), device)
    return rng.lattice(key, s, n_loc, _LATTICE_G[dims], device)


def _primary_state(key, cfg: RenderConfig, cam: Camera, gbuf: GBuffer,
                   s: int, film=None, pos: bool = True):
    """Continuous-AA primary vertex (box filter of halfwidth film_jitter):
    bilinear, validity-weighted geometry at the jittered film position,
    the taps read from the full maps (kernel P on the card). Returns
    (nrm_geo0, pos0, wo0, valid0), all (s, n_loc, ...) for the film rows
    of ``film``; pos0 is None on the card where ``pos`` is False."""
    h, w = gbuf.dist.shape
    off, n_rows = _film_base(film, h, w)
    u = _stream_uniform(cfg, rng.fold_in(key, 991), s, n_rows * w, 2,
                        gbuf.dist.device)
    return primary_state(u, gbuf.dist, gbuf.normal_geo, gbuf.valid, off,
                         min(cfg.film_jitter, 0.5), cam, pos)


def _pos_from_idx(cam: Camera, idx, dist):
    """World position of pixel ``idx`` at view distance ``dist``."""
    w = cam.width
    uu = (idx % w).to(torch.float32) + 0.5
    vv = (idx // w).to(torch.float32) + 0.5
    x = (uu - cam.cx) / cam.focal
    y = -(vv - cam.cy) / cam.focal
    d = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    return d * dist[..., None]


def _fused_shade_eligible(cfg: RenderConfig, bsdf, envmap) -> bool:
    """Whether the fused bounce shades this configuration. Trace and shade
    must agree: fused mode records the kernel's packed inputs. (The JAX
    package also requires a TPU here; the port takes the fused structure on
    every device, with the plain versions on the CPU.)"""
    return (cfg.nee and cfg.use_mesh_normal and bsdf.kind == "disney"
            and em._is_small(envmap.shape[0], envmap.shape[1]))


def march_tables(cfg: RenderConfig, gbuf: GBuffer):
    """March tables of the scene geometry (shared by every chunk): the
    march kernels' own factors for "fused", the config's for "mip".
    "exact" reads only the depth and validity maps, and builds no mip (as
    the JAX package, it takes any film size)."""
    _check_cfg(cfg)
    if cfg.march_impl == "exact":
        return mk.MarchTables(*_march_geometry(cfg, gbuf), None, None, None,
                              0, 0)
    if cfg.march_impl == "mip":
        return mk.march_tables(*_march_geometry(cfg, gbuf),
                               mip_f=cfg.mip_factor, fine_f=cfg.fine_factor)
    return mk.march_tables(*_march_geometry(cfg, gbuf))


def _make_march_fns(cfg: RenderConfig, cam: Camera, tables):
    """(do_march, do_pair) of the configured implementation: the lobe
    march alone, and the lobe march with the NEE shadow march."""
    kw = dict(t_min_frac=2e-3, t_max_frac=3.0, bias_frac=4e-3,
              interval_frac=cfg.march_interval_frac)
    if cfg.march_impl == "fused":
        def do_march(pos, wi):
            return mk.march_single(cam, tables, pos, wi,
                                   n_steps=cfg.march_steps,
                                   fine_steps=cfg.fine_steps, **kw)

        def do_pair(pos, wi, wi_e):
            return mk.march_pair(cam, tables, pos, wi, wi_e,
                                 n_steps=cfg.march_steps,
                                 fine_steps=cfg.fine_steps,
                                 shadow_steps=cfg.shadow_steps,
                                 shadow_fine_steps=cfg.shadow_fine_steps,
                                 **kw)
        return do_march, do_pair

    if cfg.march_impl == "exact":
        def do_march(pos, wi):
            return ss.march(cam, tables.dist, tables.valid, pos, wi,
                            n_steps=cfg.march_steps,
                            vectorized=cfg.march_vectorized,
                            interval_frac=cfg.march_interval_frac)

        def do_pair(pos, wi, wi_e):
            return do_march(pos, wi), ss.occluded(
                cam, tables.dist, tables.valid, pos, wi_e,
                n_steps=cfg.shadow_steps, vectorized=cfg.march_vectorized,
                interval_frac=cfg.march_interval_frac)
        return do_march, do_pair

    def mip_march(pos, d, n_steps, fine_steps, shadow_only=False):
        return ss.march_mip(cam, tables.dist, tables.valid, tables.mip,
                            pos, d, n_steps=n_steps, fine_steps=fine_steps,
                            mip_factor=tables.mip_f, shadow_only=shadow_only,
                            fine_table=tables.fine,
                            fine_factor=tables.fine_f, lookup=onehot_gather,
                            **kw)

    def do_march(pos, wi):
        return mip_march(pos, wi, cfg.march_steps, cfg.fine_steps)

    def do_pair(pos, wi, wi_e):
        return do_march(pos, wi), mip_march(
            pos, wi_e, cfg.shadow_steps, cfg.shadow_fine_steps,
            cfg.shadow_fine_steps == 0).hit
    return do_march, do_pair


@torch.no_grad()
def _trace_chunk_paths(key, cfg: RenderConfig, cam: Camera, gbuf: GBuffer,
                       mats: Materials, envmap, bsdf=None, film=None,
                       tables=None):
    """Decision pass of one chunk: sample all stochastic choices and
    resolve visibility. Returns one BounceRecord per bounce."""
    _check_cfg(cfg)
    with _TRACE_CHUNK:
        h, w = gbuf.dist.shape
        n = h * w
        off, n_rows = _film_base(film, h, w)
        n_loc = n_rows * w
        rows = slice(off, off + n_loc)
        s = cfg.chunk
        dev = gbuf.dist.device
        if bsdf is None:
            bsdf = bsdf_mod.disney(mats)
        envmap = envmap.detach()
        env_sampler = em.build_sampler(envmap)
        nrm_geo_flat = gbuf.normal_geo.reshape(n, 3)
        if tables is None:
            tables = march_tables(cfg, gbuf)
        table = bsdf.table.detach()
        k_blob = table.shape[-1]
        # one side table, one row gather per bounce: [blob | dist hi, lo |
        # geometric normal]; hit positions reconstruct from the march depth
        mdist = tables.dist.reshape(n)
        dist_hi = mdist.to(torch.bfloat16).to(torch.float32)
        combo = prof.cat([table, dist_hi[:, None], (mdist - dist_hi)[:, None],
                          nrm_geo_flat], dim=-1)

        idx = torch.arange(off, off + n_loc, dtype=torch.int32,
                           device=dev).expand(s, n_loc)
        wo = gbuf.wo.reshape(n, 3)[rows].expand(s, n_loc, 3)
        fused = _fused_shade_eligible(cfg, bsdf, envmap)
        eh, ew = envmap.shape[0], envmap.shape[1]
        do_march, do_pair = _make_march_fns(cfg, cam, tables)

        # wavefront compaction state: base_alive gates the live rays of the
        # current bounce's arrays; film_idx maps each row of a compacted array
        # back to its (sample, pixel) slot of the chunk grid; pending holds
        # the extras of the next bounce's record
        m0 = s * n_loc
        do_compact = bool(cfg.compact_caps)
        base_alive = (gbuf.valid.reshape(n)[rows].expand(s, n_loc)
                      if do_compact or fused else None)
        film_idx = None
        pending = None

        def caps_abs(b_next):
            frac = cfg.compact_caps[min(b_next - 1, len(cfg.compact_caps) - 1)]
            cap = int(-(-(frac * m0) // 1024) * 1024)
            return max(min(cap, m0), 1024)

        records = []
        for b in range(cfg.max_depth - 1):
            with _TRACE_BOUNCE[b]:
                k_lobe, k_uv, k_nee = rng.split(rng.fold_in(key, b), 3)
                rec_blob = rec_nrm = None
                extras = pending
                pending = None
                if b == 0:
                    with _TRACE_PRIMARY:
                        blob = table[rows]
                        if cfg.film_jitter > 0.0:
                            nrm_geo, pos, wo, valid0 = _primary_state(
                                key, cfg, cam, gbuf, s, film)
                            if base_alive is not None:
                                base_alive = base_alive & valid0
                        else:
                            nrm_geo = nrm_geo_flat[rows]
                            pos = gbuf.position.reshape(n, 3)[rows].expand(
                                s, n_loc, 3)
                else:
                    with _TRACE_FETCH:
                        fetched = row_gather(combo, idx)
                        blob = fetched[..., :k_blob]
                        pos = _pos_from_idx(cam, idx, fetched[..., k_blob]
                                            + fetched[..., k_blob + 1])
                        nrm_geo = fetched[..., k_blob + 2:k_blob + 5]
                        if cfg.replay_blob:
                            rec_blob = (blob[..., :5] if fused else blob).to(
                                torch.bfloat16)
                            rec_nrm = (nrm_geo.to(torch.bfloat16)
                                       if cfg.use_mesh_normal else None)
                nrm = (nrm_geo if cfg.use_mesh_normal
                       else _normalize9(blob[..., 5:8]))

                with _TRACE_DRAWS:
                    u1 = _stream_uniform(cfg, k_lobe, s, n_loc, 1, dev)
                    u2 = _stream_uniform(cfg, k_uv, s, n_loc, 2, dev)
                    u_nee = (_stream_uniform(cfg, k_nee, s, n_loc, 2, dev)
                             if cfg.nee else None)
                    if film_idx is not None:
                        # compacted bounce: the streams are drawn on the full
                        # grid (the uncompacted estimator's values) and the
                        # surviving rays' draws pulled through in one gather
                        # (film_idx ascends)
                        ug = prof.cat([u1, u2] + ([u_nee] if cfg.nee else []),
                                      -1)
                        up = gather_rows_coherent(ug.reshape(m0, -1),
                                                  film_idx)[None]
                        u1 = up[..., 0:1]
                        u2 = up[..., 1:3]
                        u_nee = up[..., 3:5] if cfg.nee else None
                with _TRACE_SAMPLE:
                    wi = bsdf.sample_dirs(blob, u1[..., 0], u2, wo, nrm)
                    pos = pos.expand(wi.shape)
                    if cfg.nee:
                        wi_e, pdf_e = em.sample_dir(env_sampler, u_nee)
                with _TRACE_MARCH:
                    if cfg.nee:
                        hit, shadowed = do_pair(pos, wi, wi_e.expand(wi.shape))
                    else:
                        hit = do_march(pos, wi)
                        shadowed = torch.zeros(wi.shape[:-1], dtype=torch.bool,
                                               device=dev)
                if fused:
                    # the fused shade's packed detached inputs, in one
                    # launch on the card (kernel H); the march chain keeps
                    # the exact f32 lobe direction
                    with _TRACE_RECORDS:
                        aux, recb, rec_nrmf = bounce_record(
                            env_sampler.m_pdf, env_sampler.c_pdf, wi, wi_e,
                            pdf_e, hit.hit, shadowed, base_alive, nrm)
                        records.append(BounceRecord(
                            shadowed, hit.hit, hit.idx, blob=rec_blob,
                            nrm=rec_nrmf, aux=aux, recb=recb, extras=extras))
                else:
                    with _TRACE_SAMPLE:
                        if cfg.nee:
                            uv_e = em.bilinear_coords(wi_e, eh, ew)
                            pdf_at = em.pdf_dir(env_sampler, wi)
                        uv_b = em.bilinear_coords(wi, eh, ew)
                    with _TRACE_RECORDS:
                        records.append(_bounce_record(
                            shadowed, hit, wi,
                            (wi_e, pdf_e, uv_e, pdf_at) if cfg.nee else None,
                            uv_b, rec_blob, rec_nrm, extras))

                with _TRACE_COMPACT:
                    if do_compact and b < cfg.max_depth - 2:
                        # stable-partition the live rays (hit and alive) of
                        # this bounce; bounce b+1 runs on the compacted prefix
                        # only. One gather pulls their continuation state
                        # through: [vertex idx | film hi, lo | exact f32 lobe
                        # direction]
                        cap = caps_abs(b + 1)
                        sel, count = compact_sel(
                            (hit.hit & base_alive).reshape(-1), cap)
                        if film_idx is None:
                            film_src = torch.arange(
                                m0, dtype=torch.int32,
                                device=dev).reshape(s, n_loc)
                        else:
                            film_src = film_idx[None]
                        f_hi, f_lo = _f32_exact_split(film_src)
                        pack_src = prof.cat(
                            [hit.idx.to(torch.float32)[..., None],
                             f_hi[..., None], f_lo[..., None], wi], -1)
                        pack = gather_rows_coherent(pack_src.reshape(-1, 6),
                                                    sel)
                        idx = pack[:, 0].to(torch.int32)[None]      # (1, cap)
                        film_idx = _f32_exact_join(pack[:, 1],
                                                   pack[:, 2])      # (cap,)
                        wo = -pack[None, :, 3:6]
                        base_alive = (torch.arange(cap, dtype=torch.int32,
                                                   device=dev)
                                      < count)[None]                # (1, cap)
                        pending = (sel, count, idx[0], film_idx)
                    else:
                        idx = hit.idx
                        wo = -wi
                        if fused:
                            # a dead ray stays dead: the packed gates of later
                            # bounces depend on this alive chain
                            base_alive = base_alive & hit.hit
        return tuple(records)


def _bounce_record(shadowed, hit, wi, nee, uv_b, rec_blob, rec_nrm,
                   extras) -> BounceRecord:
    """One bounce's generic record (the fused shade's comes from
    ``bounce_record``). ``nee``: (wi_e, pdf_e, uv_e, pdf_at) of the NEE
    sample, or None."""
    rec_wi = wi.to(torch.bfloat16)
    if nee is not None:
        wi_e, pdf_e, uv_e, pdf_at = nee
        rec_pdf_at = pdf_at.to(torch.bfloat16)
        rec_uvi = torch.stack([uv_e[0], uv_e[1], uv_b[0], uv_b[1]], -1)
        rec_uvf = torch.stack([uv_e[2], uv_e[3], uv_b[2], uv_b[3]], -1)
    else:
        rec_pdf_at = None
        rec_uvi = torch.stack([uv_b[0], uv_b[1]], -1)
        rec_uvf = torch.stack([uv_b[2], uv_b[3]], -1)
    rec_uvi = rec_uvi.to(torch.int16)
    rec_uvf = rec_uvf.to(torch.bfloat16)
    return BounceRecord(
        shadowed, hit.hit, hit.idx, rec_blob, rec_nrm,
        wi_e.to(torch.bfloat16) if nee is not None else None,
        pdf_e.to(torch.bfloat16) if nee is not None else None,
        rec_pdf_at, rec_wi, rec_uvi, rec_uvf, extras=extras)


def _shade_chunk(key, records, cfg: RenderConfig, cam: Camera,
                 gbuf: GBuffer, mats: Materials, envmap, bsdf=None,
                 film=None):
    """Replay pass of one chunk: the differentiable radiance (n_rows, w, 3)
    of the film rows of ``film`` (default: all of them) from the trace
    records (same key ⇒ the same primary state)."""
    with _SHADE_CHUNK:
        h, w = gbuf.dist.shape
        n = h * w
        off, n_rows = _film_base(film, h, w)
        n_loc = n_rows * w
        rows = slice(off, off + n_loc)
        s = cfg.chunk
        dev = gbuf.dist.device
        if bsdf is None:
            bsdf = bsdf_mod.disney(mats)
        nrm_table = gbuf.normal_geo.reshape(n, 3).detach()
        valid = gbuf.valid.reshape(n)[rows]
        idx = torch.arange(off, off + n_loc, dtype=torch.int32,
                           device=dev).expand(s, n_loc)
        wo = gbuf.wo.reshape(n, 3)[rows].expand(s, n_loc, 3)
        alive = valid.expand(s, n_loc)
        throughput = torch.ones((s, n_loc, 3), dtype=torch.float32,
                                device=dev)
        radiance = torch.zeros((s, n_loc, 3), dtype=torch.float32,
                               device=dev)

        if cfg.sky_background:
            sky = em.lookup_bilinear(envmap, -gbuf.wo.reshape(n, 3)[rows])
            radiance = radiance + torch.where(valid[None, :, None], 0.0,
                                              sky[None])

        def prev_dir(field, sel):
            """wo of a bounce: minus the previous bounce's recorded lobe
            direction, pulled through the partition ``sel`` of a compacted
            bounce and normalized after the bf16 round trip."""
            w_prev = field.to(torch.float32)
            if sel is not None:
                w_prev = gather_rows_coherent(w_prev.reshape(-1, 3),
                                              sel)[None]
            return -_normalize9(w_prev)

        use_fused = _fused_shade_eligible(cfg, bsdf, envmap)
        m0 = s * n_loc
        film_rad = None   # (m0, 3) radiance of the compacted bounces
        for b in range(cfg.max_depth - 1):
            with _SHADE_BOUNCE[b]:
                rec = records[b]
                packed = rec.aux is not None
                if use_fused != packed:
                    raise ValueError(
                        "trace records do not match the shade mode")
                with _SHADE_FETCH:
                    sel = None
                    if rec.extras is not None:
                        # compacted bounce: the throughput chain follows
                        # the stable partition through a differentiable
                        # gather; everything else is a read of the
                        # compacted records
                        sel, count, vtx_idx, film_pos = rec.extras
                        cap = sel.shape[0]
                        throughput = gather_coherent_diff(
                            throughput.reshape(-1, 3), sel)[None]
                        idx = vtx_idx[None]
                        alive = (torch.arange(cap, dtype=torch.int32,
                                              device=dev) < count)[None]
                        if film_rad is None:
                            film_rad = torch.zeros((m0, 3),
                                                   dtype=torch.float32,
                                                   device=dev)

                    if sel is not None and not packed:
                        wo = prev_dir(records[b - 1].wi, sel)
                    if b == 0 and cfg.film_jitter > 0.0:
                        nrm_geo, _, wo, valid0 = _primary_state(
                            key, cfg, cam, gbuf, s, film, pos=False)
                        blob = bsdf.table[rows]
                        alive = alive & valid0
                    elif b == 0:
                        blob = bsdf.table[rows]
                        nrm_geo = nrm_table[rows]
                    elif rec.blob is not None and \
                            bsdf.gather_reuse is not None:
                        # rows fetched by the trace: free forward, C′
                        # adjoint
                        blob = bsdf.gather_reuse(idx,
                                                 rec.blob.to(torch.float32))
                        nrm_geo = (rec.nrm.to(torch.float32)
                                   if rec.nrm is not None and not packed
                                   else None)
                    else:
                        blob = bsdf.gather(idx)
                        nrm_geo = (None if packed
                                   else row_gather(nrm_table, idx))
                    if packed:
                        # wo is not recorded: the previous bounce's win
                        # record gives it (b = 0: the primary wo)
                        tgt = rec.aux.shape[:-1]
                        if b > 0:
                            wo_d = prev_dir(records[b - 1].aux[..., 0:3],
                                            sel)
                        else:
                            wo_d = wo.expand(tgt + (3,))

                with _SHADE_EVAL:
                    if packed:
                        auxf = prof.cat([wo_d.to(torch.bfloat16), rec.aux],
                                        -1)
                        throughput, contrib_b = shade_bounce_fused(
                            envmap, blob[..., :5].expand(tgt + (5,)),
                            throughput.expand(tgt + (3,)), rec.nrm, auxf,
                            rec.recb)
                    else:
                        throughput, contrib_b, wo = _shade_generic(
                            cfg, bsdf, envmap, rec, blob, idx, nrm_geo, wo,
                            alive, throughput)

                with _SHADE_FILM:
                    if sel is not None:
                        # contributions return to their film slots through
                        # a differentiable scatter-add into the running
                        # buffer, in place (padding rows carry exact zeros:
                        # their gates are dead)
                        film_rad = scatter_add_coherent_into(
                            film_rad, contrib_b.reshape(-1, 3), film_pos)
                    else:
                        radiance = radiance + contrib_b
                alive = alive & rec.hit
                idx = rec.idx

        with _SHADE_FILM:
            if film_rad is not None:
                radiance = radiance + film_rad.reshape(s, n_loc, 3)
            img = torch.mean(radiance, dim=0)
            return torch.nan_to_num(img, nan=0.0, posinf=0.0,
                                    neginf=0.0).reshape(n_rows, w, 3)


def _shade_generic(cfg, bsdf, envmap, rec, blob, idx, nrm_geo, wo, alive,
                   throughput):
    """One bounce of the unfused shade from its generic record: (new
    throughput, contribution, next wo)."""
    nrm = (nrm_geo if cfg.use_mesh_normal
           else _normalize9(blob[..., 5:8]))
    uvi = rec.uvi.to(torch.int32)
    uvf = rec.uvf.to(torch.float32)
    if cfg.nee:
        wi_e = rec.wi_e.to(torch.float32)
        pdf_e = rec.pdf_e.to(torch.float32)
        le = em.lookup_bilinear_at(envmap, uvi[..., 0], uvi[..., 1],
                                   uvf[..., 0], uvf[..., 1])
        f_e, pdf_b_at_e = bsdf.eval(blob, idx, wi_e, wo, nrm)
        w_mis = pdf_e / (pdf_e + pdf_b_at_e.detach() + 1e-9)
        contrib = throughput * f_e / (pdf_e + 1e-9) * w_mis * le
        contrib_b = torch.where((alive & ~rec.shadowed)[..., None],
                                contrib, 0.0)
    else:
        contrib_b = 0.0
    wi = _normalize9(rec.wi.to(torch.float32))
    f_b, pdf_b = bsdf.eval(blob, idx, wi, wo, nrm)
    pdf_b = pdf_b.detach()
    weight = bsdf.weight(f_b, pdf_b)
    o = 2 if cfg.nee else 0
    le_miss = em.lookup_bilinear_at(
        envmap, uvi[..., o], uvi[..., o + 1], uvf[..., o], uvf[..., o + 1])
    w_mis_b = (pdf_b / (pdf_b + rec.pdf_at.to(torch.float32) + 1e-9)
               if cfg.nee else 1.0)
    contrib_b = contrib_b + torch.where(
        (alive & ~rec.hit)[..., None],
        throughput * weight * w_mis_b * le_miss, 0.0)
    return throughput * weight, contrib_b, -wi


def n_chunks_of(cfg: RenderConfig) -> int:
    return max(cfg.spp // cfg.chunk, 1)


def trace_step_records(key, cfg: RenderConfig, cam: Camera, gbuf: GBuffer,
                       mats: Materials, envmap, bsdf=None, film=None,
                       keys=None):
    """Decision/visibility pass of a full step: per-chunk records. Nothing
    in the result carries gradient."""
    if keys is None:
        keys = rng.split(key, n_chunks_of(cfg))
    tables = march_tables(cfg, gbuf)
    return tuple(_trace_chunk_paths(keys[i], cfg, cam, gbuf, mats, envmap,
                                    bsdf, film, tables)
                 for i in range(n_chunks_of(cfg)))


def _record_chunks(records):
    """The per-chunk record tuples inside any nesting of groups."""
    if records and isinstance(records[0], BounceRecord):
        yield records
    else:
        for r in records:
            yield from _record_chunks(r)


def compact_cap_utilization(records):
    """Largest live-count / cap of each compacted bounce over the chunks
    of ``records`` (one ``trace_step_records`` result or a list of them):
    [(bounce, 0-d tensor)]. A saturated cap drops live rays, which dims
    the image; callers read the tensors at the cadence they print."""
    fracs = {}
    for chunk in _record_chunks(records):
        for b, rec in enumerate(chunk):
            if rec.extras is not None:
                sel, count = rec.extras[0], rec.extras[1]
                fracs.setdefault(b, []).append(
                    count.to(torch.float32) / float(sel.shape[-1]))
    return [(b, torch.stack(v).max()) for b, v in sorted(fracs.items())]


def probe_compact_caps(key, cfg: RenderConfig, cam: Camera, gbuf: GBuffer,
                       mats: Materials, envmap, bsdf=None,
                       margin: float = 1.3):
    """Measure the per-bounce alive fractions on one uncompacted chunk and
    return ``compact_caps`` sized with ``margin``, rounded up to 1/16ths.
    The fractions depend on the geometry (fixed during an optimization)
    and weakly on roughness; the margin absorbs that drift. Reads the
    fractions back to the host: call it once, before the loop."""
    cfg_p = cfg._replace(spp=min(cfg.chunk, cfg.spp), compact_caps=())
    recs = trace_step_records(key, cfg_p, cam, gbuf, mats, envmap, bsdf)[0]
    alive = gbuf.valid.reshape(-1)[None].expand(recs[0].hit.shape)
    caps = []
    for b in range(cfg.max_depth - 2):
        alive = alive & recs[b].hit
        frac = float(alive.to(torch.float32).mean())
        caps.append(min(max(-(-frac * margin * 16 // 1), 1) / 16.0, 1.0))
    return tuple(caps)


def shade_from_records(key, records, cfg: RenderConfig, cam: Camera,
                       gbuf: GBuffer, mats: Materials, envmap, bsdf=None,
                       film=None, keys=None):
    """Differentiable radiance (n_rows, w, 3): the mean of the chunk
    shades."""
    n_chunks = n_chunks_of(cfg)
    if keys is None:
        keys = rng.split(key, n_chunks)
    total = None
    for i in range(n_chunks):
        img = _shade_chunk(keys[i], records[i], cfg, cam, gbuf, mats, envmap,
                           bsdf, film)
        total = img if total is None else total + img
    return total / n_chunks


def render_with_bsdf(key, cfg: RenderConfig, cam: Camera, gbuf: GBuffer,
                     mats: Materials, envmap, bsdf=None, film=None,
                     keys=None):
    """Trace then shade with an arbitrary BSDF closure set, chunk by
    chunk: a chunk's records are dropped after its shade unless the graph
    of a differentiable render holds on to them. The image is (n_rows, w,
    3) for a FilmSlice, else (h, w, 3)."""
    n_chunks = n_chunks_of(cfg)
    if keys is None:
        keys = rng.split(key, n_chunks)
    tables = march_tables(cfg, gbuf)
    total = None
    for i in range(n_chunks):
        records = _trace_chunk_paths(keys[i], cfg, cam, gbuf, mats, envmap,
                                     bsdf, film, tables)
        img = _shade_chunk(keys[i], records, cfg, cam, gbuf, mats, envmap,
                           bsdf, film)
        total = img if total is None else total + img
    return total / n_chunks


def render(key, cfg: RenderConfig, cam: Camera, gbuf: GBuffer,
           mats: Materials, envmap):
    """MC estimate with cfg.spp samples per pixel, differentiable w.r.t.
    ``mats`` and ``envmap``."""
    return render_with_bsdf(key, cfg, cam, gbuf, mats, envmap)
