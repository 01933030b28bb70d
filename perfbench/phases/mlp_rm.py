"""Phase ``mlp_rm`` on the program: loop 1's ``rm`` material phase of
``optimize`` at ``InverseOptions()`` (``opt/loop.py``, ``get_mat_phase(
"mlp", "rm")``). The material SIREN (``make_brdf_net("arm")``) maps the
clamped start rows [albedo, 0.7, 0.05] to roughness and metallic; albedo
and normal stay at the current maps; the loss is the ratio-normalised
sRGB loss with the maps' distance from their start; AdamW under the
floored step-LR. Every piece is the port's own, built as ``optimize``
builds it; only the start maps, the weights' seed, the envmap and the
compaction probe are the benchmark's (``configs/siren512.json``,
``assumed``)."""

from __future__ import annotations

import types

import torch

INPUTS = "best_results"
PART = "rm"


def build(conf: dict, inp: dict, seed: int, dev):
    from materialist_tpu_torch.camera import norm
    from materialist_tpu_torch.models.posmlp import make_brdf_net
    from materialist_tpu_torch.opt import schedules
    from materialist_tpu_torch.opt.loop import (material_loss_of,
                                                mlp_maps_of, start_arm_of)
    from materialist_tpu_torch.render.scene import Materials

    net_c, opt_c, loss_c = conf["network"], conf["optimiser"], conf["loss"]
    albedo = inp["albedo"]
    h, w = albedo.shape[:2]
    # loop 1 of opt_src "a": roughness and metallic start at their shifts
    rough = torch.full((h, w, 1), loss_c["r_shift"], device=dev)
    metal = torch.full((h, w, 1), loss_c["m_shift"], device=dev)
    normal = inp["normal"] / torch.clamp_min(norm(inp["normal"]), 1e-9)
    ori = Materials(albedo, rough, metal, normal)
    net = make_brdf_net(net_c["output_type"],
                        torch.Generator().manual_seed(seed))
    opt = schedules.adamw_steplr(
        opt_c["lr"], step_size=opt_c["step_size"], gamma=opt_c["gamma"],
        floor=opt_c["floor"], weight_decay=opt_c["weight_decay"])
    return types.SimpleNamespace(
        params=net.to(dev), extra=(ori._asdict(), inp["envmap"]),
        maps_of=mlp_maps_of(start_arm_of(ori, net_c["output_type"]), PART,
                            (h, w), net_c["output_type"]),
        loss_of=material_loss_of(PART, inp["gt"], ori,
                                 loss_c["scale_delta"]),
        opt=opt, read=lambda aux: aux[0],
        probe=(Materials(*(inp[k] for k in Materials._fields)),
               inp["envmap"]))
