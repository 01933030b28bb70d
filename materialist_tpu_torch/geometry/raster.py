"""Host-side triangle rasterizer (z-buffered) for object insertion
(counterpart of ``materialist_tpu/geometry/raster.py``; numpy only).

Insertion rasterizes the object meshes into depth, normal and mask
buffers and composites them with the scene heightfield; the path tracer
then shades everything uniformly. Vectorized per triangle over its
bounding box.
"""

from __future__ import annotations

import numpy as np

from materialist_tpu_torch.camera import Camera


def rasterize(vertices: np.ndarray, faces: np.ndarray, cam: Camera,
              layer: str = "front"):
    """Project + z-buffer a mesh (camera at origin, -z forward).

    Returns (dist (H,W) float32 — +inf (front) / -inf (back) where not
    covered, normal (H,W,3), mask (H,W) bool). Vertices follow the
    renderer's world convention (z < 0 in front of the camera).

    ``layer="front"`` keeps the NEAREST surface with normals oriented
    toward the camera; ``layer="back"`` keeps the FARTHEST surface with
    normals oriented away — the exit interface for two-interface
    dielectric tracing.
    """
    front = layer == "front"
    h, w = cam.height, cam.width
    dist = np.full((h, w), np.inf if front else -np.inf, np.float32)
    normal = np.zeros((h, w, 3), np.float32)

    v = vertices.astype(np.float64)
    z = -v[:, 2]
    fverts = v[faces]                      # (M, 3, 3)
    fz = z[faces]                          # (M, 3)
    # cull triangles behind the camera
    ok = (fz > 1e-6).all(axis=1)
    fverts = fverts[ok]
    fz = fz[ok]

    # screen coords (u, v) per vertex
    u = cam.cx + cam.focal * fverts[..., 0] / fz - 0.5
    vv = cam.cy - cam.focal * fverts[..., 1] / fz - 0.5

    fnorm = np.cross(fverts[:, 1] - fverts[:, 0], fverts[:, 2] - fverts[:, 0])
    nrm = fnorm / np.maximum(np.linalg.norm(fnorm, axis=-1, keepdims=True),
                             1e-12)
    # orient toward (front) / away from (back) the camera
    center = fverts.mean(axis=1)
    toward = (nrm * -center).sum(-1)
    flip = (toward < 0) if front else (toward > 0)
    nrm[flip] = -nrm[flip]

    inv_z = 1.0 / fz                        # interpolate 1/z (perspective)

    for i in range(len(fverts)):
        x0, x1 = int(np.floor(u[i].min())), int(np.ceil(u[i].max()))
        y0, y1 = int(np.floor(vv[i].min())), int(np.ceil(vv[i].max()))
        x0, x1 = max(x0, 0), min(x1, w - 1)
        y0, y1 = max(y0, 0), min(y1, h - 1)
        if x0 > x1 or y0 > y1:
            continue
        xs = np.arange(x0, x1 + 1)
        ys = np.arange(y0, y1 + 1)
        px, py = np.meshgrid(xs, ys)
        # barycentric coordinates
        ax, ay = u[i, 0], vv[i, 0]
        bx, by = u[i, 1], vv[i, 1]
        cx_, cy_ = u[i, 2], vv[i, 2]
        den = (by - cy_) * (ax - cx_) + (cx_ - bx) * (ay - cy_)
        if abs(den) < 1e-12:
            continue
        l0 = ((by - cy_) * (px - cx_) + (cx_ - bx) * (py - cy_)) / den
        l1 = ((cy_ - ay) * (px - cx_) + (ax - cx_) * (py - cy_)) / den
        l2 = 1.0 - l0 - l1
        inside = (l0 >= -1e-9) & (l1 >= -1e-9) & (l2 >= -1e-9)
        if not inside.any():
            continue
        iz = l0 * inv_z[i, 0] + l1 * inv_z[i, 1] + l2 * inv_z[i, 2]
        d = 1.0 / np.maximum(iz, 1e-12)
        win = dist[y0:y1 + 1, x0:x1 + 1]
        closer = inside & ((d < win) if front else (d > win))
        dist[y0:y1 + 1, x0:x1 + 1] = np.where(closer, d, win)
        normal[y0:y1 + 1, x0:x1 + 1] = np.where(closer[..., None], nrm[i],
                                                normal[y0:y1 + 1,
                                                       x0:x1 + 1])
    mask = np.isfinite(dist)
    return dist, normal, mask
