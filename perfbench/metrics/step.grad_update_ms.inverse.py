"""``step.grad_update_ms.inverse``: mean synchronised span of the step
call (shade, loss, adjoint, optimiser update) in the traced window."""

from perfbench.metrics._common import span_ms


def read(ctx):
    return span_ms(ctx, "step")
