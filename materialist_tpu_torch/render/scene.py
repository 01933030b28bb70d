"""Scene containers: G-buffer + material maps (counterpart of
``materialist_tpu/render/scene.py``). The depth map is the geometry."""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from materialist_tpu_torch.camera import Camera, norm, normals_from_depth
from materialist_tpu_torch.io import image as image_io


class GBuffer(NamedTuple):
    """Per-pixel geometry derived from the depth map. All (H, W, ...)."""
    position: torch.Tensor    # (H, W, 3) world position
    normal_geo: torch.Tensor  # (H, W, 3) depth-gradient normal
    dist: torch.Tensor        # (H, W)   -z distance used by the marcher
    wo: torch.Tensor          # (H, W, 3) unit direction surface → camera
    valid: torch.Tensor       # (H, W)   bool, False for sky/masked pixels


class Materials(NamedTuple):
    """Differentiable material maps."""
    albedo: torch.Tensor     # (H, W, 3)
    roughness: torch.Tensor  # (H, W, 1)
    metallic: torch.Tensor   # (H, W, 1)
    normal: torch.Tensor     # (H, W, 3) shading normal


def make_gbuffer(depth, camera: Optional[Camera] = None,
                 flip_depth: bool = True, mask=None,
                 device=None) -> GBuffer:
    """G-buffer from a predicted depth map; ``flip_depth`` applies the
    reference's ``2*max(d) - d`` mirror, ``mask`` (>0 = masked) removes
    geometry so the camera sees the envmap there."""
    depth = torch.as_tensor(np.asarray(depth) if not torch.is_tensor(depth)
                            else depth, dtype=torch.float32, device=device)
    if depth.ndim == 3:
        depth = depth[..., 0]
    if camera is None:
        camera = Camera(height=depth.shape[0], width=depth.shape[1])
    dist = 2.0 * depth.max() - depth if flip_depth else depth
    if mask is not None:
        mask = torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask)
                               else mask, device=depth.device)
        if mask.ndim == 3:
            mask = mask[..., 0]
        valid = ~(mask > 0)
    else:
        valid = torch.ones_like(dist, dtype=torch.bool)
    valid = valid & (dist > 1e-6)
    dist = torch.where(valid, dist, torch.zeros_like(dist))
    pos = camera.unproject(dist)
    n_geo = normals_from_depth(pos)
    wo = -pos / torch.clamp_min(norm(pos), 1e-9)
    return GBuffer(pos, n_geo, dist, wo, valid)


def load_best_results(root_dir: str, roughness_remap: bool = True) -> dict:
    """Load an optimized material dir: albedo/roughness/metallic/normal.exr
    (+ optional bg.png, mask.png, envmap.hdr) as numpy arrays.
    ``roughness_remap`` applies the reference's r*0.95+0.05."""
    def rd(name):
        return image_io.read(os.path.join(root_dir, name))

    mat = {
        "albedo": rd("albedo.exr")[..., :3],
        "roughness": rd("roughness.exr")[..., :1],
        "metallic": rd("metallic.exr")[..., :1],
        "normal": rd("normal.exr")[..., :3],
    }
    if roughness_remap:
        mat["roughness"] = mat["roughness"] * 0.95 + 0.05
    bg_path = os.path.join(root_dir, "bg.png")
    if os.path.exists(bg_path):
        bg = image_io.read(bg_path)[..., :3]
        if bg.shape[:2] != mat["albedo"].shape[:2]:
            bg = image_io.resize_bilinear_align_corners(
                bg, mat["albedo"].shape[:2])
        mat["bg"] = bg
    mask_path = os.path.join(root_dir, "mask.png")
    if os.path.exists(mask_path):
        mask = image_io.read(mask_path)
        if mask.ndim == 3:
            mask = mask[..., 0]
        mat["mask"] = mask > 0.5
    env_path = os.path.join(root_dir, "envmap.hdr")
    if os.path.exists(env_path):
        mat["envmap"] = image_io.read(env_path)
    return mat
