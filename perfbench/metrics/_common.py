"""What the metric readers share. Each reader's ``read(ctx)`` returns a
number, or ``None`` where its cell gives nothing to read. ``ctx`` holds
``unit`` ("step" or "pass"), ``unit_ms`` (each unit of the window),
``window_s``, ``setup_s``, ``peak_bytes``, ``spans`` (label → ms of each
synchronised span of a traced window) and ``profile`` (the reduction of
one unit under ``torch.profiler``, ``perfbench/profiling.py``)."""

from __future__ import annotations

import re
import statistics

from perfbench import files

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, FP32 operations/s outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def per_unit_ms(ctx, unit):
    if ctx["unit"] != unit or not ctx["unit_ms"]:
        return None
    return ctx["window_s"] * 1e3 / len(ctx["unit_ms"])


def span_ms(ctx, label):
    ms = ctx["spans"].get(label)
    return statistics.fmean(ms) if ms else None


def profiled(ctx, unit, key, scale=1.0):
    prof = ctx["profile"]
    if ctx["unit"] != unit or prof is None or prof["device_ops"] == 0:
        return None
    return prof[key] * scale


def roofline_share(prof):
    """The program's kernels' share of their roofline in the profiled unit:
    Σ over their launches of max(bytes / 3.35 TB/s, operations / 67
    TFLOP/s), each from the launch's counted shape by
    ``perfbench/roofline/<counter>.py``, over Σ of their device time. A
    kernel that some launch of the unit gives no bound for (its counter
    carries no shape, or not what the bound needs) is left out of both
    sums, with every counter that runs it. None where nothing is left."""
    by_shape = prof["launches_by_shape"]
    left_out = set()
    for name in prof["launches"]:
        mod = files.load("roofline", name)
        shapes = [s for (n, s) in by_shape if n == name]
        if not shapes or any(mod.bound(s) is None for s in shapes):
            left_out.update(mod.KERNELS)
    secs = 0.0
    for (name, shape), n in by_shape.items():
        mod = files.load("roofline", name)
        if left_out.intersection(mod.KERNELS):
            continue
        nbytes, flops = mod.bound(shape)
        secs += n * max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S)
    us = sum(t for k, t in prof["port_by_name"].items()
             if not any(re.search(rf"\b{kn}\b", k) for kn in left_out))
    if secs == 0.0 or us == 0.0:
        return None
    return 100.0 * secs / (us / 1e6)
