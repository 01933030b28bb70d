"""Phase ``raw_maps`` on the program: the four material maps and the
envmap as leaves, optimised jointly by Adam at a fixed rate against MSE +
L1 of the sRGB image (the port's ``bench.py`` step)."""

from __future__ import annotations

import types

import torch

INPUTS = "best_results"
LEAVES = ("albedo", "roughness", "metallic", "normal", "envmap")


def build(conf: dict, inp: dict, seed: int, dev):
    from materialist_tpu_torch.ops.color import linear_to_srgb
    from materialist_tpu_torch.opt import schedules
    from materialist_tpu_torch.render.scene import Materials

    params = {k: inp[k].clone().requires_grad_() for k in LEAVES}
    gt_srgb = linear_to_srgb(inp["gt"])

    def maps_of(p, extra):
        return Materials(*(p[k] for k in LEAVES[:4])), p["envmap"]

    def loss_of(maps, img, extra):
        pred = linear_to_srgb(img)
        loss = (torch.mean((pred - gt_srgb) ** 2)
                + torch.mean(torch.abs(pred - gt_srgb)))
        return loss, loss.detach()

    return types.SimpleNamespace(
        params=params, extra=None, maps_of=maps_of, loss_of=loss_of,
        opt=schedules.adam_plain(conf["lr"]), read=lambda aux: aux,
        probe=(Materials(*(inp[k] for k in LEAVES[:4])), inp["envmap"]))
