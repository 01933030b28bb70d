"""Object insertion: composite external meshes into the G-buffer scene
(counterpart of ``materialist_tpu/render/insertion.py``).

The scene gains ``oi.ply`` (dielectric acrylic glass, ior 1.49) and
``oi2.ply`` (diffuse 0.8 grey). The meshes are rasterized into depth and
normal buffers (``geometry/raster.py``) and composited where they are
closer than the heightfield; the diffuse insert shades with the
Monte-Carlo estimator, the glass insert deterministically by two-interface
refraction (``render/glass.py``) over the glass-free rendering.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from materialist_tpu_torch.camera import Camera, norm, normals_from_depth
from materialist_tpu_torch.geometry.ply import read_ply
from materialist_tpu_torch.geometry.raster import rasterize
from materialist_tpu_torch.render import forward
from materialist_tpu_torch.render import glass as glass_mod
from materialist_tpu_torch.render.scene import GBuffer, Materials

ACRYLIC_IOR = 1.49


def composite_gbuffer(gbuf: GBuffer, cam: Camera, meshes):
    """Insert rasterized meshes into the G-buffer. Returns (new gbuf on
    the device of ``gbuf``, per-mesh masks as numpy arrays)."""
    dev = gbuf.dist.device
    dist = gbuf.dist.cpu().numpy()
    valid = gbuf.valid.cpu().numpy()
    normals = gbuf.normal_geo.cpu().numpy().copy()
    masks = []
    for verts, faces in meshes:
        d_m, n_m, cover = rasterize(verts, faces, cam)
        closer = cover & ((d_m < dist) | ~valid)
        dist = np.where(closer, d_m, dist)
        normals = np.where(closer[..., None], n_m, normals)
        masks.append(closer)
    dist_t = torch.as_tensor(dist, dtype=torch.float32, device=dev)
    pos = cam.unproject(dist_t)
    # heightfield normals are recomputed only outside the inserted masks
    # (the meshes keep their exact face normals)
    any_mask = np.zeros_like(dist, bool)
    for m in masks:
        any_mask |= m
    any_t = torch.as_tensor(any_mask, device=dev)
    n_geo = torch.where(any_t[..., None],
                        torch.as_tensor(normals, dtype=torch.float32,
                                        device=dev),
                        normals_from_depth(pos))
    wo = -pos / torch.clamp_min(norm(pos), 1e-9)
    return GBuffer(pos, n_geo, dist_t, wo, gbuf.valid | any_t), masks


def render_insert(scene_dir: str, mat: dict, gbuf: GBuffer, cam: Camera,
                  envmap, n_iter: int = 10, spp: int = 32,
                  seed: int = 0) -> np.ndarray:
    """Render the scene with oi.ply / oi2.ply inserted (spp 32 × 10 passes
    averaged), on the device of ``gbuf``."""
    dev = gbuf.dist.device
    glass_mesh = None
    diffuse_meshes = []
    for name, kind in (("oi.ply", "glass"), ("oi2.ply", "diffuse")):
        p = os.path.join(scene_dir, name)
        if os.path.exists(p):
            v, f = read_ply(p)
            if kind == "glass":
                glass_mesh = (v, f)
            else:
                diffuse_meshes.append((v, f))
    if glass_mesh is None and not diffuse_meshes:
        raise FileNotFoundError(
            f"object insertion requires oi.ply/oi2.ply in {scene_dir}")

    # scene + diffuse insert (glass-free): the Monte-Carlo base
    base_gbuf, masks = (composite_gbuffer(gbuf, cam, diffuse_meshes)
                        if diffuse_meshes else (gbuf, []))
    albedo = np.asarray(mat["albedo"]).copy()
    rough = np.asarray(mat["roughness"]).copy()
    metal = np.asarray(mat["metallic"]).copy()
    normal = np.asarray(mat["normal"]).copy()
    base_normal = base_gbuf.normal_geo.cpu().numpy()
    for m in masks:
        albedo[m] = 0.8         # diffuse 0.8 grey
        rough[m] = 1.0
        metal[m] = 0.0
        normal[m] = base_normal[m]

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)
    mats = Materials(t(albedo), t(rough), t(metal), t(normal))
    base = forward.render_averaged(base_gbuf, cam, mats, envmap,
                                   n_iter=n_iter, spp=spp, denoise=True,
                                   seed=seed)
    if glass_mesh is None:
        return base

    # glass insert: deterministic two-interface dielectric
    v, f = glass_mesh
    front_d, front_n, cover = rasterize(v, f, cam, layer="front")
    back_d, back_n, _ = rasterize(v, f, cam, layer="back")
    glass_mask = cover & ((front_d < base_gbuf.dist.cpu().numpy())
                          | ~base_gbuf.valid.cpu().numpy())
    if not glass_mask.any():
        return base
    l_glass = glass_mod.shade_glass(
        cam, base_gbuf.dist, base_gbuf.valid, base, envmap, front_d,
        front_n, back_d, back_n, glass_mask, ior=ACRYLIC_IOR)
    return np.where(glass_mask[..., None], l_glass.cpu().numpy(), base)
