"""``shade.host_ms.relight``: host ms a relight pass spends in its
chunks' shades (the program's ``shade.chunk`` spans under
``forward.pass``), median over the window's passes."""

from perfbench.metrics._program import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "pass", "forward.pass", "shade.chunk")
