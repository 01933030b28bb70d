"""The material SIREN's model operations in a step of ``siren512``,
counted from the configuration's widths (``network``) and the program's
counter ``posmlp.rows.<output_type>`` of that network (never by hooking
the program): the material net's rows only, not the envmap net's, which
has other widths.

A dense layer of K inputs and N outputs costs K·N multiply-adds a row
forward, as many for its weight gradient, and as many for its input
gradient; the first layer's input (the embedded coordinates and the
start maps) takes no gradient. The sines, the embedding, the output
transform, the maps' clamps and AdamW are elementwise and left out. A
step runs the SIREN forward without a graph in ``phase.trace_all`` and
forward then backward in ``phase.step`` (``maps_of``, then the pullback
of the maps' cotangent into the weights): rows counted under the first
root cost a forward, rows under the second a forward and a backward.

``is_matmul`` tells a matrix product's kernel by its name: cuBLAS's
``…gemm…`` kernels and the split-K reduction some of them finish with
(``splitKreduce``).
"""

from __future__ import annotations

import json
import os

from perfbench.metrics._program import counted_per_unit
from perfbench.reference.phase_mlp_rm import widths as layer_widths

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "siren512.json")
TRACE, STEP = "phase.trace_all", "phase.step"


def network() -> dict:
    with open(CONFIG) as f:
        return json.load(f)["network"]


def forward_macs(net: dict) -> int:
    """Multiply-adds a row of one forward."""
    return sum(k * n for k, n in layer_widths(net))


def input_grad_macs(net: dict) -> int:
    """Multiply-adds a row of the input gradients (all layers but the
    first)."""
    return sum(k * n for k, n in layer_widths(net)[1:])


def step_flops(net: dict, traced_rows: int, step_rows: int) -> int:
    """Operations of a step whose trace evaluates ``traced_rows`` rows and
    whose differentiated step ``step_rows``."""
    f = forward_macs(net)
    return 2 * (f * traced_rows + (2 * f + input_grad_macs(net)) * step_rows)


def rows_counter(net: dict) -> str:
    """The program's counter of the rows that ``net`` evaluates."""
    return f"posmlp.rows.{net['output_type']}"


def window_rows(ctx):
    """(trace rows, step rows), medians over the window's steps, or None
    where the program counts none."""
    name = rows_counter(network())
    rows = tuple(counted_per_unit(ctx, "step", (root,), name)
                 for root in (TRACE, STEP))
    return rows if all(rows) else None


def profiled_rows(ctx):
    """(trace rows, step rows) of the profiled step, or None."""
    if ctx.get("unit") != "step" or ctx.get("profile") is None:
        return None
    try:
        from materialist_tpu_torch.utils.profiling import recent
    except ImportError:
        return None
    name, rows = rows_counter(network()), []
    for root in (TRACE, STEP):
        recs = [r for r in recent(root) if r["profiled"]]
        rows.append(recs[-1]["counts"].get(name, 0) if recs else 0)
    return tuple(rows) if all(rows) else None


def is_matmul(kernel: str) -> bool:
    name = kernel.lower()
    return "gemm" in name or "splitkreduce" in name
