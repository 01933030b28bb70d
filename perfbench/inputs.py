"""The inputs of every cell, read from the in-repo scene and handed to both
the program and the plain reference: float32 tensors on the run's device.

Files are decoded by the program's image reader (EXR, HDR, PNG), the
decoded arrays are the inputs; nothing the program computes from them is
shared. A map at another size than the film is resized by two fixed
triangle-filter matrices (half-pixel centres, widened when shrinking, each
row normalised), which is what ``jax.image.resize(..., "bilinear")``
computes, applied in float64.

Two input sets, named by the configuration files:

* ``best_results``: the scene's recorded ``best_results`` maps as they
  are stored, the envmap, the photo and the depth;
* ``relight``: ``best_results`` as ``render_final --mode real`` loads
  it: roughness remapped to 0.95·r + 0.05.
"""

from __future__ import annotations

import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def triangle_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) weights of a bilinear resize along one axis:
    output i samples (i + 0.5)·in/out − 0.5; the triangle widens by
    in/out when shrinking; weights divided by their sum; a sample outside
    [-0.5, in − 0.5] gets none. Computed in float32 in that order."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.5))
    x = (np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / max(inv_scale, f32(1.0)))
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(np.float64)


def resize(x, res: int) -> np.ndarray:
    """(H, W[, C]) → (res, res, C) float32."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        x = x[..., None]
    if x.shape[:2] == (res, res):
        return x
    w_y = triangle_matrix(res, x.shape[0])
    w_x = triangle_matrix(res, x.shape[1])
    rows = np.tensordot(w_y, x.astype(np.float64), axes=(1, 0))
    return np.tensordot(rows, w_x, axes=(1, 1)).transpose(0, 2, 1).astype(
        np.float32)


def _read(path: str) -> np.ndarray:
    from materialist_tpu_torch.io import image as image_io
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return np.asarray(image_io.read(path), np.float32)


def load(conf: dict, which: str, device) -> dict:
    """The named input set of configuration ``conf`` at its film size:
    albedo (R, R, 3), roughness, metallic (R, R, 1), normal (R, R, 3),
    envmap (16, 32, 3), gt (R, R, 3) linear, depth (R, R)."""
    scene = os.path.join(ROOT, conf["scene"])
    br = os.path.join(scene, "best_results")
    res = conf["film"]
    out = {"depth": resize(_read(os.path.join(scene, "depthPred.exr"))
                           [..., :1], res)[..., 0],
           "gt": resize(_read(os.path.join(scene, "gt_image.exr"))
                        [..., :3], res),
           "envmap": _read(os.path.join(br, "envmap.hdr"))[..., :3]}
    if which not in ("best_results", "relight"):
        raise ValueError(f"unknown input set {which!r}")
    rough = _read(os.path.join(br, "roughness.exr"))[..., :1]
    if which == "relight":
        rough = rough * 0.95 + 0.05
    maps = {"albedo": _read(os.path.join(br, "albedo.exr"))[..., :3],
            "roughness": rough,
            "metallic": _read(os.path.join(br, "metallic.exr"))[..., :1],
            "normal": _read(os.path.join(br, "normal.exr"))[..., :3]}
    for k, v in maps.items():
        out[k] = resize(v, res)
    return {k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32,
                               device=device) for k, v in out.items()}
