"""Colour-space helpers (counterpart of ``materialist_tpu/ops/color.py``)."""

from __future__ import annotations

import torch


def srgb_to_linear(img):
    """Pure gamma-2.2 transfer, as the reference uses."""
    return torch.clamp_min(img, 0.0) ** 2.2


def linear_to_srgb(img):
    """Pure gamma-1/2.2 transfer, floored at 1e-8 so the gradient at exact
    zeros (fully shadowed pixels) stays finite."""
    return torch.clamp_min(img, 1e-8) ** (1.0 / 2.2)


def luminance(rgb):
    """BT.601 luma used by the envmap CDF builder."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
