"""``relight_pass_ms``: the window's wall time over the relight passes
completed in it."""

from perfbench.metrics._common import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "pass")
