"""Masked material edits (counterpart of ``materialist_tpu/render/
edits.py``): an ``albedo`` edit shifts HSV inside the mask, roughness and
metallic edits set a scalar inside the mask. The material dict holds
numpy arrays, as the loaders give them.
"""

from __future__ import annotations

import numpy as np
import torch

from materialist_tpu_torch.ops.color import hsv_to_rgb, rgb_to_hsv


def adj_albedo(albedo, hue_shift):
    """HSV shift: hsv = clip(hsv + shift)."""
    hsv = rgb_to_hsv(torch.clamp(albedo, 0.0, 1.0))
    shift = torch.as_tensor(np.asarray(hue_shift), dtype=hsv.dtype,
                            device=hsv.device).reshape(1, 1, 3)
    return hsv_to_rgb(torch.clamp(hsv + shift, 0.0, 1.0))


def apply_edits(mat: dict, edit: dict):
    """Apply the CLI edit dict to a loaded material dict. Returns the
    edit_flag filename suffix."""
    edit_flag = ""
    for key, val in edit.items():
        if val is None:
            continue
        if "mask" not in mat:
            raise FileNotFoundError("Unable to edit img, no mask found")
        mask = np.asarray(mat["mask"])
        if key == "albedo":
            shifted = adj_albedo(
                torch.as_tensor(np.asarray(mat[key]), dtype=torch.float32),
                np.asarray(val)).numpy()
            mat[key] = np.where(mask[..., None], shifted, mat[key])
            edit_flag += f"_{key[:1]}_{np.asarray(val).reshape(-1)[0]}"
        else:
            mat[key] = np.where(mask[..., None], float(val), mat[key])
            edit_flag += f"_{key[:1]}_{val}"
    return edit_flag
