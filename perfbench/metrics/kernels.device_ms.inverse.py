"""``kernels.device_ms.inverse``: device ms of the program's own kernels
(the ``__global__``s of ``csrc/``) in the profiled step."""

from perfbench.metrics._common import profiled


def read(ctx):
    return profiled(ctx, "step", "port_us", 1e-3)
