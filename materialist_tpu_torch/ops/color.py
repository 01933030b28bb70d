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


def rgb_to_hsv(rgb):
    """Vectorized RGB→HSV on [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), 0.0)
    safe = torch.clamp_min(delta, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, 0.0, torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv):
    """Vectorized HSV→RGB on [0, 1]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int64), 6)[..., None]

    def choose(options):
        return torch.gather(torch.stack(options, dim=-1), -1, i)[..., 0]

    return torch.stack([choose([v, q, p, p, t, v]), choose([t, v, v, q, p, p]),
                        choose([p, p, t, v, v, q])], dim=-1)
