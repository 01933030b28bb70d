"""The estimator's draws (``threefry_draw``), one launch at (hashed values
n, samples a value s, bytes a sample b, the kernel's mode): the n·s
samples written once, nothing read; Threefry-2x32's 73 integer
operations a hashed value, each counted once (the card's integer rate is
below the FP32 peak they are divided by, so the count is a floor), from
``chip_smoke.py:1640-1641`` and ``OPS_THREEFRY`` (``:142``)."""

KERNELS = ("threefry_bits_kernel", "threefry_uniform_kernel",
           "threefry_lattice_kernel")


def bound(shape):
    n, s, b, _ = shape
    return n * s * b, n * 73
