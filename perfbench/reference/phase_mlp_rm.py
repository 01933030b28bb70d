"""Reference phase ``mlp_rm``: loop 1's roughness-and-metallic phase of
the default inversion, with the material SIREN (Materialist
``mymodels/mlps.py:129``, ``inverse_img_w_mi.py``) written out as plain
float32 functions over a dict of leaves named as the program's module
names its parameters (``lins.0.weight`` … ``lin_out.bias``).

The SIREN: the pixel's (row, col) embedded as [x, sin 2ᵏx, cos 2ᵏx] for
k < ``multires``, then the 5 start channels, 15 wide; layers of widths
``dims``, each one before a skip narrower by the input's width, the
input concatenated again before each layer in ``skips``; sine
activations; a zero output layer; 1.3·tanh(x) + start, clamped to [0, 1]
with the identity's gradient. Roughness is 0.93·y₃ + 0.07 and metallic
y₄, each clamped; albedo and normal are the current maps, held. The
loss: the image scaled to the photo's mean, 3·(l1/mse)·mse + l1 of its
sRGB with the ratio held constant, plus 0.1·(mean |r − 0.7| + mean
|m − 0.05|). AdamW (decay 0.01) under the step-LR 3e-4 · 0.8^⌊t/100⌋
floored at 1.5e-4.

Departures from upstream, all the benchmark's: the start maps are the
scene's recorded albedo and normal, not MaterialNet's prediction; the
weights are drawn from the run's seed, in the program's order of draws
(each layer's weight, then its bias, uniform in ±1/√fan-in, on a CPU
generator); the envmap is held at the recorded one; float32 throughout.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.step import Adam, Phase, step_lr


def widths(net: dict):
    """(fan-in, fan-out) of each layer, the output layer last."""
    in_w = 2 + 4 * net["multires"] + net["color_ch"]
    skips, dims = net["skips"], net["dims"]
    out, x_w = [], in_w
    for layer, d in enumerate(dims):
        o = d - in_w if layer + 1 in skips else d
        if layer in skips:
            x_w += in_w
        out.append((x_w, o))
        x_w = o
    if len(dims) in skips:
        x_w += in_w
    return out + [(x_w, net["out"])]


def init_params(net: dict, seed: int, device) -> dict:
    """The leaves at their seeded start."""
    g = torch.Generator().manual_seed(seed)
    layers = widths(net)
    params = {}
    for i, (k, n) in enumerate(layers[:-1]):
        bound = 1.0 / math.sqrt(k)
        params[f"lins.{i}.weight"] = torch.empty(n, k).uniform_(
            -bound, bound, generator=g)
        params[f"lins.{i}.bias"] = torch.empty(n).uniform_(
            -bound, bound, generator=g)
    k, n = layers[-1]
    params["lin_out.weight"] = torch.zeros(n, k)
    params["lin_out.bias"] = torch.zeros(n)
    return {name: p.to(device).requires_grad_() for name, p in
            params.items()}


def embed(x, multires: int):
    feats = [x]
    for k in range(multires):
        feats += [torch.sin((2.0 ** k) * x), torch.cos((2.0 ** k) * x)]
    return torch.cat(feats, -1)


def siren(p: dict, start, net: dict, h: int, w: int):
    """The SIREN's output rows (h·w, out) from the start rows."""
    rr, cc = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=start.device),
        torch.arange(w, dtype=torch.float32, device=start.device),
        indexing="ij")
    pts = torch.cat([embed(torch.stack([rr.reshape(-1), cc.reshape(-1)],
                                       -1), net["multires"]), start], -1)
    x = pts
    n_layers = len(net["dims"])
    for layer in range(n_layers):
        if layer in net["skips"]:
            x = torch.cat([x, pts], -1)
        x = torch.sin(x @ p[f"lins.{layer}.weight"].T
                      + p[f"lins.{layer}.bias"])
    if n_layers in net["skips"]:
        x = torch.cat([x, pts], -1)
    y = 1.3 * torch.tanh(x @ p["lin_out.weight"].T + p["lin_out.bias"]) \
        + start
    return y + (torch.clamp(y, 0.0, 1.0) - y).detach()


def srgb(img):
    return torch.clamp_min(img, 1e-8) ** (1.0 / 2.2)


def build(inp: dict, conf: dict, seed: int, device) -> Phase:
    net, opt, lc = conf["network"], conf["optimiser"], conf["loss"]
    albedo, envmap = inp["albedo"], inp["envmap"]
    h, w = albedo.shape[:2]
    normal = inp["normal"] / torch.clamp_min(
        torch.linalg.vector_norm(inp["normal"], dim=-1, keepdim=True), 1e-9)
    r0, m0 = lc["r_shift"], lc["m_shift"]
    start = torch.clamp(torch.cat(
        [albedo.reshape(-1, 3), torch.full((h * w, 1), r0, device=device),
         torch.full((h * w, 1), m0, device=device)], -1), 0.0, 1.0)
    gt = srgb(inp["gt"])
    gt_mean = torch.mean(inp["gt"])

    def maps_of(p):
        y = siren(p, start, net, h, w)
        rough = torch.clamp(y[:, 3:4] * 0.93 + 0.07, 0.0, 1.0)
        metal = torch.clamp(y[:, 4:5], 0.0, 1.0)
        return (albedo, rough.reshape(h, w, 1), metal.reshape(h, w, 1),
                normal, envmap)

    def loss_of(maps, img):
        ratio = gt_mean / torch.clamp_min(torch.mean(img).detach(), 1e-9)
        pred = srgb(img * ratio)
        mse = torch.mean((pred - gt) ** 2)
        l1 = torch.mean(torch.abs(pred - gt))
        held = (l1 / torch.clamp_min(mse, 1e-12)).detach()
        dist = (torch.mean(torch.abs(maps[1] - r0))
                + torch.mean(torch.abs(maps[2] - m0)))
        return 3.0 * held * mse + l1 + lc["scale_delta"] * dist

    return Phase(init_params(net, seed, device), maps_of, loss_of,
                 Adam(step_lr(opt["lr"], opt["step_size"], opt["gamma"],
                              opt["floor"]),
                      weight_decay=opt["weight_decay"]))
