"""``step.trace_ms.inverse``: mean synchronised span of
``PhaseStep.trace_all`` a step in the traced window."""

from perfbench.metrics._common import span_ms


def read(ctx):
    return span_ms(ctx, "trace_all")
