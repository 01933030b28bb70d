"""Memory-aware step planning: choose (groups, chunk, replay_blob,
keep_records) for an inverse step at a given (res, spp) (counterpart of
``materialist_tpu/opt/plan.py``).

The byte constants are the JAX package's estimates for its TPU programs,
kept as they are; they are not measured for this package on an H100. The
memory size comes from the device: ``total_memory`` of the CUDA device,
or the JAX package's 16 GiB when planning for the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# bytes per path-vertex of trace records (replay / record-light), per
# path-vertex of the shade adjoint's working set, and per primary ray of
# the trace's in-flight state: the JAX package's estimates (unmeasured
# here)
REPLAY_REC_BYTES = 66.0
LIGHT_REC_BYTES = 42.0
SHADE_VJP_BYTES = 192.0
TRACE_CHUNK_BYTES = 320.0

CPU_PLAN_BYTES = 16 * 1024 ** 3
HEADROOM = 0.50


class StepPlan(NamedTuple):
    groups: int
    chunk: int
    replay_blob: bool
    keep_records: bool


def device_bytes(device) -> int:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return CPU_PLAN_BYTES


def plan_step(res: int, spp: int, hbm_bytes: int = CPU_PLAN_BYTES,
              bounces: int = 3, max_chunk: int = 8,
              vert_frac: float = 1.0) -> StepPlan:
    """Pick accumulation/record settings that fit ``hbm_bytes``; fastest
    first: replay records cached, record-light cached, record-light
    re-traced per group."""
    budget = hbm_bytes * HEADROOM
    n_px = res * res
    verts_total = float(n_px) * spp * bounces * vert_frac

    groups = 1
    while (verts_total / groups) * SHADE_VJP_BYTES > 0.5 * budget \
            and groups < spp:
        groups *= 2
    spp_group = max(spp // groups, 1)
    chunk = min(max_chunk, spp_group)
    while float(n_px) * chunk * TRACE_CHUNK_BYTES > 0.5 * budget \
            and chunk > 1:
        chunk //= 2

    def fits(rec_bytes, cached, g):
        rec = verts_total * rec_bytes if cached \
            else (verts_total / g) * rec_bytes
        return rec + (verts_total / g) * SHADE_VJP_BYTES <= budget

    for rec_bytes, replay in ((REPLAY_REC_BYTES, True),
                              (LIGHT_REC_BYTES, False)):
        for g in (groups, 2 * groups, 4 * groups):
            if g > spp:
                break
            if fits(rec_bytes, cached=True, g=g):
                return StepPlan(g, min(chunk, max(spp // g, 1)),
                                replay, True)
    return StepPlan(groups, chunk, False, False)
