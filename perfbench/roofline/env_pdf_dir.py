"""Kernel D′ (``env_pdf_dir``), one launch at (queries m, envmap h, w):
a direction in, a pdf out, 16 B a query, the pdf tables once, 60
operations a query, from ``chip_smoke.py:1246,1298-1299``."""

KERNELS = ("env_pdf_dir_kernel",)


def bound(shape):
    m, h, w = shape
    return m * 16 + (4 * 2 * (h + h * w)) // 2, m * 60
