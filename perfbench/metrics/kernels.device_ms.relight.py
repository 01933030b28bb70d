"""``kernels.device_ms.relight``: device ms of the program's own kernels
(the ``__global__``s of ``csrc/``) in the profiled pass."""

from perfbench.metrics._common import profiled


def read(ctx):
    return profiled(ctx, "pass", "port_us", 1e-3)
