"""Kernel P (``primary_state``), the jittered primary vertex, one launch
at (rows m, film h, w, pos0 written 0 / 1): read once, the jitter's two
uniforms (8 B) a row and the maps at their own size, each pixel's
distance (4 B), geometric normal (12 B) and validity (1 B); written once,
the normal (12 B), the position where asked (12 B), the outgoing
direction (12 B) and the validity (1 B) a row; about 100 operations a
row (the jitter, the four taps' weights and products, their sums, three
divisions, two norms and five divisions by them), held against its
device time at ``chip_smoke.py:1404-1430``."""

KERNELS = ("primary_state_kernel",)


def bound(shape):
    m, h, w, pos = shape
    return (m * 8 + h * w * (4 + 12 + 1) + m * (12 + 12 * pos + 12 + 1),
            m * 100)
