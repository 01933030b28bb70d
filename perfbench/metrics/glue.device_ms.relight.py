"""``glue.device_ms.relight``: device ms of every other device operation
(PyTorch's kernels, copies, fills) in the profiled pass."""

from perfbench.metrics._common import profiled


def read(ctx):
    return profiled(ctx, "pass", "glue_us", 1e-3)
