"""``posmlp.gemm_roofline.siren512``: the material SIREN's model operations
in the profiled step (``_posmlp_flops.step_flops`` from that step's
``posmlp.rows.arm``) over the device time of its matrix products' kernels
(``_posmlp_flops.is_matmul``), as a share of the card's FP32 peak (67
TFLOP/s), in %. The path tracer runs no matrix product, so those kernels
are the SIREN's. Nothing where the step ran no such kernel or the program
counts no rows."""

from perfbench.metrics._common import PEAK_FP32_PER_S, profiled
from perfbench.metrics._posmlp_flops import (is_matmul, network,
                                             profiled_rows, step_flops)


def read(ctx):
    if not profiled(ctx, "step", "device_ops"):
        return None
    us = sum(t for name, t in ctx["profile"]["by_name"].items()
             if is_matmul(name))
    rows = profiled_rows(ctx)
    if not us or rows is None:
        return None
    return 100.0 * step_flops(network(), *rows) / (us / 1e6) \
        / PEAK_FP32_PER_S
