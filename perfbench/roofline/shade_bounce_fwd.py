"""Kernel B (``shade_bounce_fwd``), one launch at (m rows, envmap h, w):
104 B of records and state a row in and out plus the envmap once, 260
operations a row (two BRDF evaluations, two fetches, MIS), from
``chip_smoke.py:922-923`` and ``FLOPS_SHADE_FWD`` (``:131``)."""

KERNELS = ("shade_fwd_kernel",)


def bound(shape):
    m, h, w = shape
    return m * (80 + 24) + h * w * 3 * 4, m * 260
