"""``step_ms``: the window's wall time over the steps completed in it."""

from perfbench.metrics._common import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "step")
