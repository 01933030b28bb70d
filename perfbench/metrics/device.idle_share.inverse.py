"""``device.idle_share.inverse``: 1 − the union of the device's operation
intervals in the profiled step over the mean step of the traced window."""

import statistics

from perfbench.metrics._common import profiled


def read(ctx):
    busy_us = profiled(ctx, "step", "busy_us")
    if busy_us is None:
        return None
    return 1.0 - busy_us / 1e3 / statistics.fmean(ctx["unit_ms"])
