"""``phase.host_ms.siren512``: the host ms of the program's
``phase.trace_all`` and ``phase.step`` roots of a step, summed, median
over the window's steps. The benchmark synchronises just outside each in
a traced window, so this is the host's own time to issue a step: against
``step_ms`` it says whether the host or the card sets the pace."""

from perfbench.metrics._program import median, window_records


def read(ctx):
    trace = window_records(ctx, "step", "phase.trace_all")
    step = window_records(ctx, "step", "phase.step")
    if not trace or not step:
        return None
    n = min(len(trace), len(step))
    return median([a["host_ms"] + b["host_ms"]
                   for a, b in zip(trace[-n:], step[-n:])])
