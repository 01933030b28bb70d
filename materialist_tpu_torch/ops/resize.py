"""Resize ops for MaterialNet (counterpart of
``materialist_tpu/ops/resize.py``), on NCHW tensors on their own device.

- ``bilinear_align_corners``: the DPT decoder's upsampling and the
  restore of the predicted maps to the input size;
- ``bicubic_scale``: DINOv2's pos-embed interpolation by a scale factor
  (A = -0.75, half-pixel centres, no antialias);
- ``bicubic_resize``: the input's resize to a multiple of the patch size,
  with the semantics of cv2's ``INTER_CUBIC`` (the same cubic kernel and
  half-pixel grid, edges replicated).
"""

from __future__ import annotations

import torch.nn.functional as F


def bilinear_align_corners(x, size):
    """x (B, C, H, W) → (B, C, th, tw), align_corners=True bilinear."""
    return F.interpolate(x, size=tuple(int(s) for s in size),
                         mode="bilinear", align_corners=True)


def bicubic_scale(x, scale_hw):
    """x (B, C, H, W) → (B, C, int(H·sy), int(W·sx)); the sample grid
    uses the scale as given, not the ratio of the rounded sizes."""
    return F.interpolate(x, scale_factor=tuple(float(s) for s in scale_hw),
                         mode="bicubic", align_corners=False)


def bicubic_resize(x, size):
    """x (B, C, H, W) → (B, C, th, tw), cv2 ``INTER_CUBIC`` semantics."""
    return F.interpolate(x, size=tuple(int(s) for s in size),
                         mode="bicubic", align_corners=False)
