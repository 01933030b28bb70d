"""Shared CLI plumbing: output-dir resolution and scene loading
(counterpart of ``materialist_tpu/cli/common.py``)."""

from __future__ import annotations

import os

from materialist_tpu_torch import config as gconfig
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.io import exr as exr_io
from materialist_tpu_torch.io import image as image_io
from materialist_tpu_torch.render.scene import GBuffer, make_gbuffer


def get_output_dir(save_name: str, save_path: str = None) -> str:
    """Output dir resolution; an absolute ``save_name`` is the dir."""
    if save_path:
        if os.path.isabs(save_path):
            return os.path.join(save_path, save_name)
        return os.path.join(gconfig.OUT_DIR, save_path, save_name)
    if os.path.isabs(save_name):
        return save_name
    return os.path.join(gconfig.OUT_DIR, save_name)


def load_scene_gbuffer(output_dir: str, camera: Camera = None,
                       device=None) -> GBuffer:
    """Render geometry from the scene dir's depthPred.exr (+ optional
    mesh_mask.png), on ``device``."""
    depth = exr_io.read(os.path.join(output_dir, "depthPred.exr"))
    mask = None
    mask_path = os.path.join(output_dir, "mesh_mask.png")
    if os.path.exists(mask_path):
        m = image_io.read(mask_path)
        if m.ndim == 3:
            m = m[..., 0]
        mask = m > 0.5
    cam = camera or Camera(depth.shape[0], depth.shape[1])
    return make_gbuffer(depth[..., 0], cam, flip_depth=True, mask=mask,
                        device=device)


def resolve_envmap(save_name: str, env_path: str = None,
                   input_path: str = None, prefer_opt: bool = False) -> str:
    """Envmap path resolution: the explicit path, or
    best_results/envmap[_opt].hdr under ``input_path``, then under
    OUT_DIR."""
    if env_path is not None:
        return env_path
    names = (["envmap_opt.hdr", "envmap.hdr"] if prefer_opt
             else ["envmap.hdr"])
    roots = []
    if input_path is not None:
        roots.append(os.path.join(input_path, save_name, "best_results"))
    roots.append(os.path.join(gconfig.OUT_DIR, save_name, "best_results"))
    for root in roots:
        for n in names:
            p = os.path.join(root, n)
            if os.path.exists(p):
                return p
    raise ValueError("No envmap found")
