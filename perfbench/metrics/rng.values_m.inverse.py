"""``rng.values_m.inverse``: millions of threefry values a step hashes
(the program's ``rng.values`` counter, ``rng.bits``'s element counts,
under ``phase.trace_all`` and ``phase.step``), median over the window's
steps."""

from perfbench.metrics._program import counted_per_unit


def read(ctx):
    v = counted_per_unit(ctx, "step", ("phase.trace_all", "phase.step"),
                         "rng.values")
    return None if v is None else v / 1e6
