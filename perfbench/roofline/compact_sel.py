"""The compaction kernel (``compact_sel``), one launch at (flags m, cap):
the flags read once, the cap's positions and the count written once,
from ``chip_smoke.py:1216``."""

KERNELS = ("compact_count_kernel", "compact_write_kernel")


def bound(shape):
    m, cap = shape
    return m + 4 * cap + 4, 0
