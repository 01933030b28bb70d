"""Two-interface dielectric shading for inserted glass objects
(counterpart of ``materialist_tpu/render/glass.py``).

A smooth dielectric is deterministic: each camera ray splits into one
Fresnel-weighted reflection and one refraction chain, so no Monte-Carlo
draw is needed.

* entry interface: the rasterized FRONT layer of the glass mesh
  (``geometry/raster.py``, nearest surface, camera-facing normals);
* exit interface: the rasterized BACK layer (farthest surface, outward
  normals); the refracted ray meets it by a short screen-space fixed-point
  iteration on the back depth layer;
* exact unpolarized Fresnel splits the energy between the reflected ray
  (marched against the scene heightfield by the "exact" march, envmap on a
  miss) and the doubly refracted ray (the same treatment);
* total internal reflection at the exit reflects once off the back
  interface and exits straight.
"""

from __future__ import annotations

import numpy as np
import torch

from materialist_tpu_torch.camera import Camera, norm, sqrt
from materialist_tpu_torch.ops import envmap as em
from materialist_tpu_torch.render import screenspace as ss


def refract(d, n, eta):
    """Snell refraction of unit direction ``d`` (pointing INTO the
    surface) at unit normal ``n`` (opposing d); eta = ior_in/ior_out.
    Returns (refracted unit dir, tir mask)."""
    cos_i = -torch.sum(d * n, dim=-1, keepdim=True)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k[..., 0] < 0.0
    t = eta * d + (eta * cos_i - sqrt(torch.clamp_min(k, 0.0))) * n
    return t / torch.clamp_min(norm(t), 1e-9), tir


def reflect(d, n):
    """Mirror reflection of direction ``d`` about normal ``n``."""
    return d - 2.0 * torch.sum(d * n, dim=-1, keepdim=True) * n


def fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel reflectance. cos_i: |cos| of
    the incident angle; eta = ior_in/ior_out for the transmission side.
    Returns R in [0, 1] (1 under total internal reflection)."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin_t2 = eta * eta * (1.0 - cos_i * cos_i)
    cos_t = sqrt(torch.clamp_min(1.0 - sin_t2, 0.0))
    r_s = (eta * cos_i - cos_t) / torch.clamp_min(eta * cos_i + cos_t, 1e-9)
    r_p = (cos_t * eta - cos_i) / torch.clamp_min(eta * cos_t + cos_i, 1e-9)
    r = 0.5 * (r_s * r_s + r_p * r_p)
    return torch.where(sin_t2 > 1.0, 1.0, torch.clamp(r, 0.0, 1.0))


def _project_px(cam: Camera, p):
    """World point → nearest pixel (row, col) int64, clamped."""
    z = torch.clamp_min(-p[..., 2], 1e-6)
    u = cam.cx + cam.focal * p[..., 0] / z
    v = cam.cy - cam.focal * p[..., 1] / z
    ui = torch.clamp(u.to(torch.int32), 0, cam.width - 1)
    vi = torch.clamp(v.to(torch.int32), 0, cam.height - 1)
    return vi.long(), ui.long()


def _march_to_background(cam: Camera, dist_map, valid_map, bg_img, envmap,
                         pos, d, n_steps=48):
    """Radiance along the ray (pos, d): march the scene heightfield; the
    object-free background at the hit pixel, the envmap on a miss."""
    hit = ss.march(cam, dist_map, valid_map, pos[None], d[None],
                   n_steps=n_steps, vectorized=True)
    sky = em.lookup_bilinear(envmap, d)
    return torch.where(hit.hit[0][..., None],
                       bg_img.reshape(-1, 3)[hit.idx[0].long()], sky)


@torch.no_grad()
def shade_glass(cam: Camera, scene_dist, scene_valid, bg_img, envmap,
                front_d, front_n, back_d, back_n, glass_mask,
                ior: float = 1.49, exit_iters: int = 3):
    """Deterministic radiance of the glass pixels.

    Args:
        scene_dist/scene_valid: (H, W) heightfield WITHOUT the glass
            object (diffuse inserts already composited).
        bg_img: (H, W, 3) linear radiance of the glass-free scene.
        front_d/front_n, back_d/back_n: rasterized entry/exit layers
            (numpy arrays or tensors).
        glass_mask: (H, W) bool, the pixels the glass mesh covers.
    Returns (H, W, 3) radiance on the device of ``scene_dist``; zeros
    outside the mask.
    """
    dev = scene_dist.device

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype, device=dev)

    glass_mask = t(glass_mask, torch.bool)
    h, w = glass_mask.shape
    n = h * w
    m = glass_mask.reshape(n)
    d1 = t(front_d).reshape(n)
    n1 = t(front_n).reshape(n, 3)
    bd = t(back_d)
    bd = torch.where(torch.isfinite(bd), bd, 0.0).reshape(n)
    bn = t(back_n).reshape(n, 3)
    d1 = torch.where(m, d1, 1.0)
    bg_img = t(bg_img)
    envmap = t(envmap)

    # entry vertex + camera ray
    px = torch.arange(n, device=dev)
    uu = (px % w).to(torch.float32) + 0.5
    vv = (px // w).to(torch.float32) + 0.5
    ray = torch.stack([(uu - cam.cx) / cam.focal, -(vv - cam.cy) / cam.focal,
                       -torch.ones((n,), device=dev)], dim=-1)
    p1 = ray * d1[:, None]
    view = ray / torch.clamp_min(norm(ray), 1e-9)

    cos_i = torch.abs(torch.sum(view * n1, dim=-1))
    r_fres = fresnel_dielectric(cos_i, 1.0 / ior)[:, None]

    # reflection branch: off the entry interface into the scene
    refl_dir = reflect(view, n1)
    l_refl = _march_to_background(cam, scene_dist, scene_valid, bg_img,
                                  envmap, p1 + 1e-3 * refl_dir, refl_dir)

    # transmission branch: refract in, cross to the back layer, refract
    # out. Exit search: fixed point on s with depth(p1 + s·t1) = back_d at
    # the projected pixel (the buffers store z-depth); rays that curve
    # toward the camera use the entry thickness
    t1, tir_in = refract(view, n1, 1.0 / ior)
    tz = torch.clamp_max(t1[..., 2], -1e-3)
    s = torch.clamp_min(bd - d1, 1e-4) / (-tz)
    for _ in range(exit_iters):
        vi, ui = _project_px(cam, p1 + s[:, None] * t1)
        q = vi * w + ui
        d_exit = torch.where(m[q], bd[q], bd)
        s = torch.clamp_min(d_exit - d1, 1e-4) / (-tz)
    p2 = p1 + s[:, None] * t1
    vi, ui = _project_px(cam, p2)
    q = vi * w + ui
    n2 = torch.where(m[q][:, None], bn[q], bn)
    # the exit normal must oppose the interior ray
    n2 = torch.where(torch.sum(t1 * n2, dim=-1, keepdim=True) > 0, -n2, n2)
    t2, tir_out = refract(t1, n2, ior)
    t2 = torch.where(tir_out[:, None], reflect(t1, n2), t2)
    l_trans = _march_to_background(cam, scene_dist, scene_valid, bg_img,
                                   envmap, p2 + 1e-3 * t2, t2)

    out = r_fres * l_refl + (1.0 - r_fres) * l_trans
    out = torch.where(tir_in[:, None], l_refl, out)
    return torch.where(m[:, None], out, 0.0).reshape(h, w, 3)
