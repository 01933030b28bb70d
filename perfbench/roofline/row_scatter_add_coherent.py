"""Kernel C′ on ascending indices (``row_scatter_add_coherent``), one
launch at (contributions m, width k, table rows n, into). Onto a new
table (into = 0): the contributions and their indices read once, the
table written once. Added into a running table (into = 1),
``chip_smoke.py:1033-1039`` counts the rows it touches read and written
(2 · touched · k · 4 bytes), and the touched rows depend on the indices,
which the counter does not carry: no bound is known for such a launch,
and the kernel's time is left out of the roofline's sums."""

KERNELS = ("scatter_rows_kernel",)


def bound(shape):
    m, k, n, into = shape
    if into:
        return None
    return m * k * 4 + m * 4 + n * k * 4, 0
