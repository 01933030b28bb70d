"""Seeded inputs shared by the tests and by ``chip_smoke.py`` (numpy and
the package only), so that the card sees what the CPU tests see: the scene
and rays of the march cases, and the two meshes of the insertion path (a
lat-long sphere and a quad)."""

import numpy as np

from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.ops.kernels import march as mk
from materialist_tpu_torch.render.scene import make_gbuffer

F = np.float32

# (case, shadow_only)
MARCH_CASES = [("frustum", False), ("two_edges", False),
               ("shadow_only", True), ("negative_pixels", False)]


def march_scene(res, seed):
    rng = np.random.default_rng(seed)
    depth = (2.0 + 0.2 * rng.uniform(size=(res, res))).astype(np.float32)
    for _ in range(5):
        r0, c0 = rng.integers(0, res - 16, 2)
        hh, ww = rng.integers(4, 16, 2)
        depth[r0:r0 + hh, c0:c0 + ww] -= rng.uniform(0.3, 0.9)
    mask = np.zeros((res, res), bool)
    mask[: res // 8, : res // 4] = True
    return depth, mask


def march_rays(case, rng, pos, nrm, n_rays):
    """Seeded rays of one case, from pixels of the 32x32 scene."""
    pix = rng.integers(0, pos.shape[0], n_rays)
    o = pos[pix].copy()
    v = rng.normal(size=(n_rays, 3)).astype(F)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    if case == "two_edges":
        # rays a little in front of the background, along the image
        # plane: they pass behind one box of the depth map after another
        o *= F(0.93)
        v[:, 2] *= F(0.02)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
    elif case == "negative_pixels":
        # origins left of and above the frustum, heading back into it
        o[:, 0] -= F(2.5) + rng.uniform(size=n_rays).astype(F)
        o[:, 1] += F(2.5) * rng.uniform(size=n_rays).astype(F)
        v[:, 0] = np.abs(v[:, 0]) + F(0.5)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
    else:
        flip = np.sum(v * nrm[pix], -1, keepdims=True) < 0
        v = np.where(flip, -v, v)
    return o.astype(F), v.astype(F)


def march_case_inputs(case, shadow_only, res=32, n_rays=2000):
    """(cam, tables, origins (n_rays, 3), directions, n_steps, fine_steps)
    of one case on the CPU, origins and directions as numpy arrays."""
    depth, mask = march_scene(res, 3)
    cam = Camera(res, res)
    gt = make_gbuffer(depth, cam, flip_depth=False, mask=mask)
    tab = mk.march_tables(gt.dist, gt.valid, mip_f=4, fine_f=2)
    rng = np.random.default_rng(len(case))
    o, d = march_rays(case, rng, gt.position.reshape(-1, 3).numpy(),
                gt.normal_geo.reshape(-1, 3).numpy(), n_rays)
    n_steps, fine_steps = (16, 2) if shadow_only else (24, 6)
    return cam, tab, o, d, n_steps, fine_steps


def sphere_mesh(center, radius, n_lat=12, n_lon=24):
    """Lat-long UV sphere: (verts (V, 3) float64, faces (F, 3) int32)."""
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    verts = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                      np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    verts = verts * radius + np.asarray(center, np.float64)
    i, j = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing="ij")
    a = (i * n_lon + j).ravel()
    b = (i * n_lon + (j + 1) % n_lon).ravel()
    c = ((i + 1) * n_lon + j).ravel()
    d = ((i + 1) * n_lon + (j + 1) % n_lon).ravel()
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)])
    return verts, faces.astype(np.int32)


def quad_mesh(corner, du, dv):
    """Two triangles spanning corner, corner + du, corner + dv."""
    c, du, dv = (np.asarray(x, np.float64) for x in (corner, du, dv))
    verts = np.stack([c, c + du, c + du + dv, c + dv])
    return verts, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
