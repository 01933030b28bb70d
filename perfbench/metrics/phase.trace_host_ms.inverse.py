"""``phase.trace_host_ms.inverse``: the host ms of the program's
``phase.trace_all`` span, median over the window's steps. The benchmark
synchronises just outside it in a traced window, so this is the host's
own time to issue a step's trace on a drained card."""

from perfbench.metrics._program import median, window_records


def read(ctx):
    recs = window_records(ctx, "step", "phase.trace_all")
    return median([r["host_ms"] for r in recs]) if recs else None
