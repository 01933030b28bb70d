"""Resize ops for MaterialNet (counterpart of
``materialist_tpu/ops/resize.py``), on NCHW tensors on their own device.

- ``bilinear_align_corners``: the DPT decoder's upsampling and the
  restore of the predicted maps to the input size. Its forward is
  PyTorch's upsampling kernel, its backward ``_separable`` with the
  transposed interpolation matrices. ``F.interpolate`` itself is no use
  to a deterministic training step: its CUDA backward adds with atomics,
  and under deterministic algorithms it switches to a decomposition of
  four gathers whose backward is a sorted ``index_put_`` (half of a
  training step's device time on an H100, PERF.md);
- ``bicubic_scale``: DINOv2's pos-embed interpolation by a scale factor
  (A = -0.75, half-pixel centres, no antialias), as the JAX package
  computes it: a fixed (out × in) matrix on each axis, applied by
  ``_separable`` forward and (transposed) backward, so no scatter;
- ``bicubic_resize``: the input's resize to a multiple of the patch size,
  with the semantics of cv2's ``INTER_CUBIC`` (the same cubic kernel and
  half-pixel grid, edges replicated).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def bilinear_align_corners(x, size):
    """x (B, C, H, W) → (B, C, th, tw), align_corners=True bilinear."""
    return _BilinearAlignCorners.apply(x, tuple(int(s) for s in size))


def _linear_matrix(out_size: int, in_size: int) -> np.ndarray:
    """The (out_size, in_size) float64 matrix of ``F.interpolate``'s
    align_corners=True linear interpolation on one axis, with its float32
    sample positions: ``(in - 1) / (out - 1) · i``, the taps at its floor
    and the next index (the last index alone at the end)."""
    f32 = np.float32
    scale = f32(in_size - 1) / f32(out_size - 1) if out_size > 1 else f32(0)
    src = scale * np.arange(out_size, dtype=f32)
    i0 = src.astype(np.int64)
    lam = (src - i0.astype(f32)).astype(np.float64)
    m = np.zeros((out_size, in_size))
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), 1.0 - lam)
    np.add.at(m, (rows, np.minimum(i0 + 1, in_size - 1)), lam)
    return m


class _BilinearAlignCorners(torch.autograd.Function):
    """Forward: the kernel that ``F.interpolate`` calls outside
    deterministic algorithms; backward ``W_yᵀ · g · W_x``."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.in_hw = tuple(x.shape[-2:])
        return torch._C._nn.upsample_bilinear2d(x, size, True, None)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (h, w), (th, tw) = ctx.in_hw, g.shape[-2:]
        w_y = _weights(_linear_matrix, th, h, g.device, g.dtype)
        w_x = _weights(_linear_matrix, tw, w, g.device, g.dtype)
        return _separable(g, w_y.t(), w_x.t()), None


def _separable(x, w_y, w_x):
    """``w_y · x · w_xᵀ`` on the last two axes of x (B, C, H, W), with
    w_y (th, H) and w_x (tw, W): two matrix products in full float32
    whatever the TF32 flags, which are switched off for the call."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return w_y @ (x @ w_x.t())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


class _Separable(torch.autograd.Function):
    """``_separable(x, w_y, w_x)``, whose backward is ``_separable``
    with the transposed matrices (the matrices take no gradient)."""

    @staticmethod
    def forward(ctx, x, w_y, w_x):
        ctx.save_for_backward(w_y, w_x)
        return _separable(x, w_y, w_x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        w_y, w_x = ctx.saved_tensors
        return _separable(g, w_y.t(), w_x.t()), None, None


def _cubic(t, a=-0.75):
    """Keys' cubic kernel in float32, term for term as the JAX package
    evaluates it: its outer branch cancels terms of ~15 into weights under
    1, so the float32 weights differ from exact ones by up to ~1e-6."""
    f32 = np.float32
    at = np.abs(t).astype(f32)
    at2, at3 = at * at, at * at * at
    f1 = f32(a + 2) * at3 - f32(a + 3) * at2 + f32(1)
    f2 = f32(a) * at3 - f32(5 * a) * at2 + f32(8 * a) * at - f32(4 * a)
    return np.where(at <= 1, f1, np.where(at < 2, f2, f32(0)))


def _cubic_matrix(out_size: int, in_size: int, scale: float) -> np.ndarray:
    """The (out_size, in_size) float64 matrix of the JAX package's
    bicubic scale on one axis: output i samples ``(i + 0.5) / scale -
    0.5``, its four taps at ``floor + k`` (k = -1..2) clipped to the edge,
    each row divided by its sum of weights. Positions and tap weights are
    the JAX package's float32 values; the sum, the division and the
    matrix are float64."""
    f32 = np.float32
    c = (np.arange(out_size, dtype=f32) + f32(0.5)) / f32(scale) - f32(0.5)
    base = np.floor(c)
    taps = [(np.clip(base + k, 0, in_size - 1).astype(np.int64),
             _cubic(c - base - f32(k)).astype(np.float64))
            for k in range(-1, 3)]
    wsum = sum(w for _, w in taps)
    m = np.zeros((out_size, in_size))
    rows = np.arange(out_size)
    for idx, w in taps:
        np.add.at(m, (rows, idx), w / wsum)
    return m


@functools.lru_cache(maxsize=None)
def _weights(matrix, *args):
    """``matrix(*args[:-2])`` as a tensor of dtype ``args[-1]`` on the
    device ``args[-2]``, made once."""
    with torch.inference_mode(False):    # usable by autograd afterwards
        return torch.as_tensor(matrix(*args[:-2]), dtype=args[-1],
                               device=args[-2])


def bicubic_scale(x, scale_hw):
    """x (B, C, H, W) → (B, C, int(H·sy), int(W·sx)); the sample grid
    uses the scale as given, not the ratio of the rounded sizes. Computed
    as ``W_y · x · W_xᵀ`` in full float32 (``_Separable``)."""
    h, w = x.shape[-2:]
    sy, sx = (float(s) for s in scale_hw)
    w_y = _weights(_cubic_matrix, int(h * sy), h, sy, x.device, x.dtype)
    w_x = _weights(_cubic_matrix, int(w * sx), w, sx, x.device, x.dtype)
    return _Separable.apply(x, w_y, w_x)


def bicubic_resize(x, size):
    """x (B, C, H, W) → (B, C, th, tw), cv2 ``INTER_CUBIC`` semantics."""
    return F.interpolate(x, size=tuple(int(s) for s in size),
                         mode="bicubic", align_corners=False)
