"""Kernel E (``env_lookup_bilinear``), one launch at (queries m, envmap h,
w): four tap coordinates in, a colour out, 28 B a query, the envmap once,
24 operations a query, from ``chip_smoke.py:1332-1333``."""

KERNELS = ("env_lookup_bilinear_kernel",)


def bound(shape):
    m, h, w = shape
    return m * (16 + 12) + h * w * 3 * 4, m * 3 * 8
