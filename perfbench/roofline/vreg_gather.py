"""Kernel G (``vreg_gather``): its wrapper counts launches without a
shape, so no bound is known for a launch (``chip_smoke.py:1590`` bounds
one at 8 B a lookup plus the table): the kernel's time is left out of the
roofline's sums. It runs on no cell of this benchmark."""

KERNELS = ("vreg_gather_smem_kernel", "onehot_gather_kernel")


def bound(shape):
    return None
