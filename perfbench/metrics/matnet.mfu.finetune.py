"""``matnet.mfu.finetune``: the fine-tuning step's model operations over
the window's mean step, as a share of the card's FP32 peak (67 TFLOP/s,
``_common.PEAK_FP32_PER_S``), in %. The operations are counted by
``_matnet_flops.step_flops`` from the configuration's widths and the
program's counters ``train.images`` and ``train.pixels`` (median over the
window's ``train.step`` records); nothing where the counters are missing,
where their pixels an image are not the configuration's crop, or where
the profiled step ran nothing on a card."""

import json
import os

from perfbench.metrics._common import PEAK_FP32_PER_S, per_unit_ms, profiled
from perfbench.metrics._matnet_flops import step_flops
from perfbench.metrics._program import counted_per_unit

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "matnet518.json")


def read(ctx):
    images = counted_per_unit(ctx, "step", ("train.step",), "train.images")
    pixels = counted_per_unit(ctx, "step", ("train.step",), "train.pixels")
    if not images or not pixels or not profiled(ctx, "step", "device_ops"):
        return None
    ms = per_unit_ms(ctx, "step")
    with open(CONFIG) as f:
        conf = json.load(f)
    side = conf["image"]
    if pixels != images * side * side:
        return None
    flops = step_flops(conf, images, side, side)["total"]
    return 100.0 * flops / (ms / 1e3) / PEAK_FP32_PER_S
