"""Kernel D (``env_sample_dir``), one launch at (queries m, envmap h, w):
two uniforms in, a direction and a pdf out, 24 B a query, the CDF and pdf
tables once, 120 operations a query, from ``chip_smoke.py:1246,1271-1272``."""

KERNELS = ("env_sample_dir_kernel",)


def bound(shape):
    m, h, w = shape
    return m * (8 + 16) + 4 * 2 * (h + h * w), m * 120
