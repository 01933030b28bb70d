"""Kernel C′ (``row_scatter_add_bf16``), one launch at (contributions m, width k,
table rows n): the contributions and their indices read once, a new
table written once, no operations counted (``chip_smoke.py:1033-1039``,
the ``base is None`` case)."""

KERNELS = ("scatter_rows_kernel",)


def bound(shape):
    m, k, n = shape
    return m * k * 4 + m * 4 + n * k * 4, 0
