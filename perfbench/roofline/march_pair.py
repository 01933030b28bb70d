"""Kernel A (``march_pair``), one launch at its counted shape (m rays).
``chip_smoke.py:731-734`` bounds it by max(bytes, operations), the
operations being 24 a march step (``FLOPS_PER_MARCH_STEP``, ``:130``)
times the steps the rays need, which ``chip_smoke.py`` counts by
replaying the march over the scene (``needed_march_steps``). The counter
gives the rays alone, not those steps, so no bound is known for a
launch: the kernel's time is left out of the roofline's sums."""

KERNELS = ("march_kernel",)


def bound(shape):
    return None
