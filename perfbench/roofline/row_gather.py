"""Kernel C (``row_gather``), one launch at (table rows n, width k,
queries m, coherent): each index read, a table row read and an output row
written a query, 4 + 8k bytes, no operations counted
(``chip_smoke.py:1394``)."""

KERNELS = ("gather_rows_kernel",)


def bound(shape):
    n, k, m, coherent = shape
    return m * (4 + 8 * k), 0
