"""``posmlp.mfu.siren512``: the material SIREN's model operations a step
(``_posmlp_flops.step_flops`` from the configuration's widths and the
program's ``posmlp.rows.arm`` under ``phase.trace_all`` and ``phase.step``,
medians over the window) over the window's mean step, as a share of the
card's FP32 peak (67 TFLOP/s, ``_common.PEAK_FP32_PER_S``), in %. Nothing
where the counter is missing or the profiled step ran nothing on a
card."""

from perfbench.metrics._common import PEAK_FP32_PER_S, per_unit_ms, profiled
from perfbench.metrics._posmlp_flops import network, step_flops, window_rows


def read(ctx):
    rows = window_rows(ctx)
    if rows is None or not profiled(ctx, "step", "device_ops"):
        return None
    ms = per_unit_ms(ctx, "step")
    return 100.0 * step_flops(network(), *rows) / (ms / 1e3) \
        / PEAK_FP32_PER_S
