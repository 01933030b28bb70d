"""``glue.device_ops.relight``: device operations other than the program's
own kernels in the profiled pass."""

from perfbench.metrics._common import profiled


def read(ctx):
    return profiled(ctx, "pass", "glue_ops")
