"""``glue.cat_mib.inverse``: MiB a step's ``torch.cat`` copies write on
the trace, shade and adjoint paths (the program's ``glue.cat_bytes``
counter under ``phase.trace_all`` and ``phase.step``), median over the
window's steps."""

from perfbench.metrics._program import counted_per_unit


def read(ctx):
    v = counted_per_unit(ctx, "step", ("phase.trace_all", "phase.step"),
                         "glue.cat_bytes")
    return None if v is None else v / 2 ** 20
