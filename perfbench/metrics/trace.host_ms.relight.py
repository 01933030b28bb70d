"""``trace.host_ms.relight``: host ms a relight pass spends in its
chunks' traces (the program's ``trace.chunk`` spans under
``forward.pass``), median over the window's passes."""

from perfbench.metrics._program import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "pass", "forward.pass", "trace.chunk")
