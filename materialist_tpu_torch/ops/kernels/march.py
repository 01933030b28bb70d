"""Screen-space marches of ``csrc/march_pair.cu``: kernel A,
``march_pair`` (lobe + NEE shadow march of a path vertex, replaces
``materialist_tpu/ops/pallas/march_kernel.py::march_pair``), and kernel
A′, ``march_single`` (one ray, with a ``shadow_only`` mode, replaces
``march_kernel.py::march_fused``).

The plain version of each march is ``render/screenspace.py::march_mip``,
as the JAX package's off-TPU path is. The tables and ``t_lo`` are
computed here in torch; the kernel takes a tile of 32 rays per warp, the
lobe and the shadow march of a vertex as separate work items. The origin
may be a broadcast over the leading (sample) axes: the kernel reads it
with a period instead of a copy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.ops.kernels import _lib
from materialist_tpu_torch.render import screenspace as ss


def _mip_factor(h: int, w: int) -> int:
    """Largest power-of-two factor whose mip has at most 1024 texels."""
    f = 1
    while (h // f) * (w // f) > 1024:
        f *= 2
    return f


def _fine_factor(h: int, w: int) -> int:
    """Factor whose fine table has at most 4096 texels."""
    f = 1
    while (h // f) * (w // f) > 4096:
        f *= 2
    return f


class MarchTables(NamedTuple):
    """Per-geometry march inputs, built once and shared by every call."""
    dist: torch.Tensor      # (H, W) march depth
    valid: torch.Tensor     # (H, W) march validity
    mip: torch.Tensor       # (H/mip_f, W/mip_f) min depth
    fine: torch.Tensor      # (H/fine_f, W/fine_f) mean depth
    t_lo: torch.Tensor      # (1,) t_min_frac · scene scale
    mip_f: int
    fine_f: int


def march_tables(dist_map, valid_map, t_min_frac: float = 2e-3,
                 mip_f: int = None, fine_f: int = None):
    """Tables with the kernels' own factors, or with the given ones (the
    "mip" march implementation takes them from the render config)."""
    h, w = dist_map.shape
    mip_f = _mip_factor(h, w) if mip_f is None else mip_f
    fine_f = _fine_factor(h, w) if fine_f is None else fine_f
    scale = torch.clamp_min(
        torch.max(torch.where(valid_map, dist_map, 0.0)), 1e-6)
    return MarchTables(dist_map, valid_map,
                       ss.build_min_mip(dist_map, valid_map, mip_f)
                       .contiguous(),
                       ss.build_fine_table(dist_map, valid_map, fine_f)
                       .contiguous(),
                       (t_min_frac * scale).reshape(1).to(torch.float32),
                       mip_f, fine_f)


def march_pair_plain(cam: Camera, tab: MarchTables, origin, d_lobe, d_nee,
                     n_steps, fine_steps, shadow_steps, shadow_fine_steps,
                     t_min_frac, t_max_frac, bias_frac, interval_frac):
    hit = ss.march_mip(cam, tab.dist, tab.valid, tab.mip, origin, d_lobe,
                       n_steps=n_steps, fine_steps=fine_steps,
                       t_min_frac=t_min_frac, t_max_frac=t_max_frac,
                       bias_frac=bias_frac, interval_frac=interval_frac,
                       mip_factor=tab.mip_f, fine_table=tab.fine,
                       fine_factor=tab.fine_f)
    shad = ss.march_mip(cam, tab.dist, tab.valid, tab.mip, origin, d_nee,
                        n_steps=shadow_steps,
                        fine_steps=max(shadow_fine_steps, 1),
                        t_min_frac=t_min_frac, t_max_frac=t_max_frac,
                        bias_frac=bias_frac, interval_frac=interval_frac,
                        mip_factor=tab.mip_f,
                        shadow_only=shadow_fine_steps == 0,
                        fine_table=tab.fine, fine_factor=tab.fine_f).hit
    return hit, shad


def _log2_exact(f: int, name: str) -> int:
    """The kernel reaches a table cell by a shift."""
    if f < 1 or f & (f - 1):
        raise ValueError(f"{name} must be a power of two, got {f}")
    return f.bit_length() - 1


def _check_tables(tab: MarchTables, dev):
    """(mip_shift, mh, mw, fine_shift, fh, fw) of the kernel call."""
    mh, mw = tab.mip.shape
    fh, fw = tab.fine.shape
    for name, t, shp in (("mip", tab.mip, (mh, mw)),
                         ("fine", tab.fine, (fh, fw)),
                         ("t_lo", tab.t_lo, (1,))):
        _lib.expect(t, name, torch.float32, shp, dev)
    if mh * mw > 1024 or fh * fw > 4096:
        raise ValueError("march tables exceed the kernel's shared memory")
    return (_log2_exact(tab.mip_f, "mip_f"), mh, mw,
            _log2_exact(tab.fine_f, "fine_f"), fh, fw)


def _origin_rows(origin):
    """origin (..., 3) as contiguous rows (R, 3) with flat ray q starting
    at row q % R: a tensor expanded over its leading axes (the samples of
    a pixel share their vertex) gives its one stored block, uncopied."""
    lead = origin.dim() - 2
    if lead > 0 and all(st == 0 or sz == 1 for st, sz in
                        zip(origin.stride()[:lead], origin.shape[:lead])):
        return origin[(0,) * lead].contiguous()
    return origin.reshape(-1, 3).contiguous()


def march_single(cam: Camera, tab: MarchTables, origin, direction,
                 n_steps: int = 24, fine_steps: int = 6,
                 t_min_frac: float = 2e-3, t_max_frac: float = 3.0,
                 bias_frac: float = 4e-3, interval_frac: float = 2.0,
                 shadow_only: bool = False):
    """Kernel A′: one march of the rays origin (..., 3) along direction.
    ``shadow_only`` stops after the coarse scan (hit = a candidate
    interval was found, idx = 0). Returns a Hit."""
    if origin.device.type == "cpu":
        return ss.march_mip(cam, tab.dist, tab.valid, tab.mip, origin,
                            direction, n_steps=n_steps,
                            fine_steps=fine_steps, t_min_frac=t_min_frac,
                            t_max_frac=t_max_frac, bias_frac=bias_frac,
                            interval_frac=interval_frac,
                            mip_factor=tab.mip_f, shadow_only=shadow_only,
                            fine_table=tab.fine, fine_factor=tab.fine_f)
    dev = origin.device
    shape = origin.shape[:-1]
    o = _origin_rows(origin)
    d = direction.reshape(-1, 3).contiguous()
    m = d.shape[0]
    _lib.expect(o, "origin", torch.float32, (o.shape[0], 3), dev)
    if m % o.shape[0]:
        raise ValueError("origin does not broadcast over the rays")
    _lib.expect(d, "direction", torch.float32, (m, 3), dev)
    geo = _check_tables(tab, dev)
    hit = torch.empty((m,), dtype=torch.bool, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    t = torch.empty((m,), dtype=torch.float32, device=dev)
    ratio = (t_max_frac / t_min_frac) ** (1.0 / max(n_steps - 1, 1))
    if m:
        _lib.check(_lib.lib().march_single_launch(
            o.data_ptr(), d.data_ptr(), tab.mip.data_ptr(),
            tab.fine.data_ptr(), tab.t_lo.data_ptr(), hit.data_ptr(),
            idx.data_ptr(), t.data_ptr(), m, o.shape[0], cam.height,
            cam.width, *geo, cam.focal, cam.cx, cam.cy, 1.0 - bias_frac,
            1.0 + bias_frac, interval_frac, n_steps, fine_steps, ratio,
            int(shadow_only), _lib.stream_ptr(o)), "march_single")
        _lib.count_launch("march_single", (m,))
    hit = hit.reshape(shape)
    return ss.Hit(hit, idx.reshape(shape), t.reshape(shape), ~hit)


def march_pair(cam: Camera, tab: MarchTables, origin, d_lobe, d_nee,
               n_steps: int = 24, fine_steps: int = 6,
               shadow_steps: int = 16, shadow_fine_steps: int = 2,
               t_min_frac: float = 2e-3, t_max_frac: float = 3.0,
               bias_frac: float = 4e-3, interval_frac: float = 2.0):
    """Both marches of the vertices origin (..., 3) along d_lobe and
    d_nee (same shape). Returns (Hit, shadowed)."""
    if origin.device.type == "cpu":
        return march_pair_plain(cam, tab, origin, d_lobe, d_nee, n_steps,
                                fine_steps, shadow_steps, shadow_fine_steps,
                                t_min_frac, t_max_frac, bias_frac,
                                interval_frac)
    dev = origin.device
    shape = origin.shape[:-1]
    o = _origin_rows(origin)
    dl = d_lobe.reshape(-1, 3).contiguous()
    dn = d_nee.reshape(-1, 3).contiguous()
    m = dl.shape[0]
    _lib.expect(o, "origin", torch.float32, (o.shape[0], 3), dev)
    if m % o.shape[0]:
        raise ValueError("origin does not broadcast over the rays")
    for name, t in (("d_lobe", dl), ("d_nee", dn)):
        _lib.expect(t, name, torch.float32, (m, 3), dev)
    geo = _check_tables(tab, dev)
    hit = torch.empty((m,), dtype=torch.bool, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    t = torch.empty((m,), dtype=torch.float32, device=dev)
    shad = torch.empty((m,), dtype=torch.bool, device=dev)
    ratio = (t_max_frac / t_min_frac) ** (1.0 / max(n_steps - 1, 1))
    s_ratio = (t_max_frac / t_min_frac) ** (1.0 / max(shadow_steps - 1, 1))
    if m:
        _lib.check(_lib.lib().march_pair_launch(
            o.data_ptr(), dl.data_ptr(), dn.data_ptr(), tab.mip.data_ptr(),
            tab.fine.data_ptr(), tab.t_lo.data_ptr(), hit.data_ptr(),
            idx.data_ptr(), t.data_ptr(), shad.data_ptr(), m, o.shape[0],
            cam.height, cam.width, *geo, cam.focal, cam.cx, cam.cy,
            1.0 - bias_frac, 1.0 + bias_frac, interval_frac, n_steps,
            fine_steps, shadow_steps, max(shadow_fine_steps, 1), ratio,
            s_ratio, int(shadow_fine_steps == 0), _lib.stream_ptr(o)),
            "march_pair")
        _lib.count_launch("march_pair", (m,))
    hit = hit.reshape(shape)
    return (ss.Hit(hit, idx.reshape(shape), t.reshape(shape), ~hit),
            shad.reshape(shape))
