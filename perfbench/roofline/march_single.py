"""Kernel A′ (``march_single``), one launch at its counted shape (m
rays). Bounded in ``chip_smoke.py:1557-1561`` by the march steps the
rays need, which the counter does not carry, as for A: no bound is known
for a launch, and the kernel's time is left out of the roofline's sums."""

KERNELS = ("march_kernel",)


def bound(shape):
    return None
