"""Reference phase ``raw_maps``: the four material maps and the envmap,
optimised directly; MSE + L1 of the sRGB image; Adam at a fixed rate."""

from __future__ import annotations

import torch

from perfbench.reference.step import Adam, Phase


def srgb(img):
    return torch.clamp_min(img, 1e-8) ** (1.0 / 2.2)


def build(inp: dict, conf: dict, seed: int, device) -> Phase:
    params = {k: inp[k].clone().requires_grad_()
              for k in ("albedo", "roughness", "metallic", "normal",
                        "envmap")}
    gt = srgb(inp["gt"])

    def maps_of(p):
        return (p["albedo"], p["roughness"], p["metallic"], p["normal"],
                p["envmap"])

    def loss_of(maps, img):
        pred = srgb(img)
        return torch.mean((pred - gt) ** 2) + torch.mean(torch.abs(pred - gt))

    return Phase(params, maps_of, loss_of,
                 Adam(lambda count, v=conf["lr"]: v))
