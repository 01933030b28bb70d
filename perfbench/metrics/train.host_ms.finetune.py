"""``train.host_ms.finetune``: the host ms of the program's ``train.step``
span, median over the window's steps. The step reads no value back inside
the span, so this is the host's time to issue a step: against ``step_ms``
it says whether the host or the card sets the pace."""

from perfbench.metrics._program import median, window_records


def read(ctx):
    recs = window_records(ctx, "step", "train.step")
    return median([r["host_ms"] for r in recs]) if recs else None
