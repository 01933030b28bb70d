"""``step_p95_ms``: the 95th percentile of the window's step times, each
from one loss on the host to the next (inclusive quantiles)."""

import statistics


def read(ctx):
    ms = ctx["unit_ms"]
    if ctx["unit"] != "step" or len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
