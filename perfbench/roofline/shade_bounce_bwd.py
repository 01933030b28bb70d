"""Kernel B′ (``shade_bounce_bwd``), one launch at (m rows, envmap h, w):
136 B a row, the envmap read and its gradient written once, 580
operations a row (the replayed forward and the adjoint, 520, plus the
envmap taps, 60), from ``chip_smoke.py:957-958`` and ``:131-133``."""

KERNELS = ("shade_bwd_kernel",)


def bound(shape):
    m, h, w = shape
    return m * (104 + 32) + 2 * h * w * 3 * 4, m * (520 + 60)
