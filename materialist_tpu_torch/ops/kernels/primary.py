"""The jittered primary vertex of a chunk (kernel P, ``csrc/primary.cu``).

With film jitter, bounce 0 starts at a jittered film position: the
bilinear, validity-weighted geometry of the four pixels around it and the
camera ray through it. The JAX package builds it from shifted copies of
the maps, which XLA fuses (``materialist_tpu/render/shader.py:323``), and
has no kernel for it. ``primary_state`` takes ``primary_state_plain`` for
CPU tensors and launches P for CUDA tensors, which writes the same bits in
one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from materialist_tpu_torch.camera import Camera, norm
from materialist_tpu_torch.ops.kernels import _lib
from materialist_tpu_torch.utils import profiling as prof


def primary_state_plain(u, dist, normal_geo, valid, off: int, r: float,
                        cam: Camera):
    """(nrm_geo0, pos0, wo0, valid0), all (s, n_loc, ...), of the film
    pixels off, off + 1, ... from the jitter draw ``u`` (s, n_loc, 2) in
    [0, 1): the sample at pixel centre + (2u − 1)·r, its geometry
    interpolated bilinearly over the valid ones of its four pixels in the
    full (h, w) maps (the replicate pad at the film's edge)."""
    h, w = dist.shape
    n = u.shape[1]
    dev = dist.device
    jit = (u * 2.0 - 1.0) * r
    ju, jv = jit[..., 0], jit[..., 1]
    base = torch.arange(off, off + n, dtype=torch.int32, device=dev)
    ub = base % w
    vb = base // w
    cu = ub.to(torch.float32) + 0.5 + ju
    cv = vb.to(torch.float32) + 0.5 + jv

    geo = prof.cat([dist[..., None], normal_geo,
                    valid[..., None].to(torch.float32)], dim=-1)
    pad = torch.nn.functional.pad(geo.permute(2, 0, 1)[None], (1, 1, 1, 1),
                                  mode="replicate")[0].permute(1, 2, 0)
    pad = pad.reshape(-1, 5).detach()

    fu = cu - 0.5
    fv = cv - 0.5
    u0 = torch.floor(fu)
    v0 = torch.floor(fv)
    wu = (fu - u0)[..., None]
    wv = (fv - v0)[..., None]
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
    valid0 = wsum[..., 0] > 1e-6
    dist0 = g[..., 0]
    nrm_geo = g[..., 1:4]
    nrm_geo = nrm_geo / torch.clamp_min(norm(nrm_geo), 1e-9)

    x = (cu - cam.cx) / cam.focal
    y = -(cv - cam.cy) / cam.focal
    d = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    pos0 = d * dist0[..., None]
    wo0 = -d / torch.clamp_min(norm(d), 1e-9)
    return nrm_geo, pos0, wo0, valid0


def primary_state(u, dist, normal_geo, valid, off: int, r: float,
                  cam: Camera, pos: bool = True):
    """Kernel P: ``primary_state_plain``'s (nrm_geo0, pos0, wo0, valid0)
    in one launch, bit for bit; pos0 is None where ``pos`` is False (the
    shade reads no position)."""
    if u.device.type == "cpu":
        return primary_state_plain(u, dist, normal_geo, valid, off, r, cam)
    h, w = dist.shape
    dev = u.device
    if u.dim() != 3 or u.shape[-1] != 2:
        raise ValueError(f"primary_state: jitter of shape {tuple(u.shape)}, "
                         "expected (s, n_loc, 2)")
    s, n_loc = u.shape[:2]
    dist, normal_geo, valid = (t.contiguous()
                               for t in (dist, normal_geo, valid))
    if n_loc % w or off % w or off < 0 or off + n_loc > h * w:
        raise ValueError(f"primary_state: pixels [{off}, {off + n_loc}) are "
                         f"not whole rows of a {h}x{w} film")
    for name, t, dt, shp in (("u", u, torch.float32, (s, n_loc, 2)),
                             ("dist", dist, torch.float32, (h, w)),
                             ("normal_geo", normal_geo, torch.float32,
                              (h, w, 3)),
                             ("valid", valid, torch.bool, (h, w))):
        _lib.expect(t, name, dt, shp, dev)
    m = s * n_loc
    nrm0 = torch.empty((s, n_loc, 3), dtype=torch.float32, device=dev)
    pos0 = (torch.empty((s, n_loc, 3), dtype=torch.float32, device=dev)
            if pos else None)
    wo0 = torch.empty((s, n_loc, 3), dtype=torch.float32, device=dev)
    valid0 = torch.empty((s, n_loc), dtype=torch.bool, device=dev)
    # PyTorch rounds a Python scalar to f32 and divides by it as a
    # multiplication by its f32 reciprocal
    inv_focal = float(np.float32(1.0) / np.float32(cam.focal))
    if m:
        _lib.check(_lib.lib().primary_state_launch(
            u.data_ptr(), dist.data_ptr(), normal_geo.data_ptr(),
            valid.data_ptr(), nrm0.data_ptr(),
            pos0.data_ptr() if pos else None, wo0.data_ptr(),
            valid0.data_ptr(), m, n_loc, off, h, w, r, cam.cx, cam.cy,
            inv_focal, _lib.stream_ptr(u)), "primary_state")
        _lib.count_launch("primary_state", (m, h, w, int(pos)))
    return nrm0, pos0, wo0, valid0
