"""``glue.device_ms.inverse``: device ms of every other device operation
(PyTorch's kernels, copies, fills) in the profiled step."""

from perfbench.metrics._common import profiled


def read(ctx):
    return profiled(ctx, "step", "glue_us", 1e-3)
