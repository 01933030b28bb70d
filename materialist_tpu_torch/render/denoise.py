"""Edge-aware à-trous wavelet denoiser (counterpart of
``materialist_tpu/render/denoise.py``).

Each of the n_iter Monte-Carlo renders of the forward path is denoised
before averaging. A pass is 25 dilated taps with joint range weights on
colour and, where given, on albedo and normal maps. It is plain tensor
code: 75 shifted taps of small elementwise operations over three passes,
about two thousand launches a call in eager PyTorch.
"""

from __future__ import annotations

import torch

_KERNEL_1D = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shift2d(img, dy: int, dx: int):
    return torch.roll(img, (dy, dx), dims=(0, 1))


@torch.no_grad()
def atrous_denoise(color, albedo=None, normal=None, n_passes: int = 3,
                   sigma_color: float = 0.25, sigma_albedo: float = 0.15,
                   sigma_normal: float = 0.3):
    """Denoise (H, W, 3) linear radiance; ``albedo`` and ``normal``
    (H, W, 3) are optional edge-stopping maps."""
    out = color
    for p in range(n_passes):
        step = 1 << p
        acc = torch.zeros_like(out)
        wacc = torch.zeros_like(out[..., :1])
        for i in range(5):
            for j in range(5):
                dy, dx = (i - 2) * step, (j - 2) * step
                c = _shift2d(out, dy, dx)
                dc = torch.sum((c - out) ** 2, dim=-1)
                w = (_KERNEL_1D[i] * _KERNEL_1D[j]) * torch.exp(
                    -dc / (2 * sigma_color ** 2))
                if albedo is not None:
                    da = torch.sum((_shift2d(albedo, dy, dx) - albedo) ** 2,
                                   dim=-1)
                    w = w * torch.exp(-da / (2 * sigma_albedo ** 2))
                if normal is not None:
                    dn = torch.sum((_shift2d(normal, dy, dx) - normal) ** 2,
                                   dim=-1)
                    w = w * torch.exp(-dn / (2 * sigma_normal ** 2))
                acc = acc + c * w[..., None]
                wacc = wacc + w[..., None]
        out = acc / torch.clamp_min(wacc, 1e-8)
    return out
