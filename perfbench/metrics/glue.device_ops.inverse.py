"""``glue.device_ops.inverse``: device operations other than the program's
own kernels in the profiled step."""

from perfbench.metrics._common import profiled


def read(ctx):
    return profiled(ctx, "step", "glue_ops")
