"""PosMLP — positional-encoded sine-activated residual MLP (counterpart of
``materialist_tpu/models/posmlp.py``): NeRF-style embedding of integer
pixel coords, sine hidden layers with torch.nn.Linear default init, skip
connections that re-concatenate the embedded input, a zero-initialized
output layer and per-head output transforms. A forward is the span
``posmlp.forward``; the rows it evaluates add to
``posmlp.rows.<output_type>`` (``.arm`` for the material net, ``.envmap``
for the envmap's),
so that each network's rows are counted at its own widths."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from materialist_tpu_torch.utils.profiling import POSMLP_ROWS, count, span

_FORWARD = span("posmlp.forward")


def positional_embed(x, num_freqs: int):
    """[x, sin(2^k x), cos(2^k x)] for k in 0..num_freqs-1."""
    if num_freqs <= 0:
        return x
    feats = [x]
    for k in range(num_freqs):
        feats.append(torch.sin((2.0 ** k) * x))
        feats.append(torch.cos((2.0 ** k) * x))
    return torch.cat(feats, dim=-1)


def grid_coords(n_rows: int, device=None):
    """Integer (row, col) coords of a flattened image of n_rows pixels:
    square if n > 512, else a 2:1 map (the 16×32 envmap)."""
    if n_rows > 512:
        h = w = int(round(math.sqrt(n_rows)))
    else:
        h = int(round(math.sqrt(n_rows / 2)))
        w = 2 * h
    if h * w != n_rows:
        raise ValueError(f"cannot infer grid for {n_rows} points")
    r = torch.arange(h, dtype=torch.float32, device=device)
    c = torch.arange(w, dtype=torch.float32, device=device)
    rr, cc = torch.meshgrid(r, c, indexing="ij")
    return torch.stack([rr.reshape(-1), cc.reshape(-1)], dim=-1)


def _straight_through_clamp(x, lo=0.0, hi=1.0):
    """clamp(x).detach() + x - x.detach()."""
    return (torch.clamp(x, lo, hi) - x).detach() + x


class PosMLP(nn.Module):
    """Layers are ``lin0..lin{L-1}`` and ``lin_out`` (the Flax names)."""

    def __init__(self, in_dims: int, out_dims: int,
                 dims: Sequence[int] = (256, 256, 256, 256),
                 skip_connection: Sequence[int] = (1, 3),
                 multires_view: int = 2, output_type: str = "envmap",
                 color_ch: int = 5, generator: torch.Generator = None):
        super().__init__()
        self.skip = tuple(skip_connection)
        self.multires = multires_view
        self.output_type = output_type
        in_width = 2 + 4 * multires_view + color_ch
        x_width = in_width
        layers = []
        for layer, d in enumerate(dims):
            out_dim = d - in_width if layer + 1 in self.skip else d
            if layer in self.skip:
                x_width += in_width
            lin = nn.Linear(x_width, out_dim)
            bound = 1.0 / math.sqrt(x_width)
            with torch.no_grad():
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.uniform_(-bound, bound, generator=generator)
            layers.append(lin)
            x_width = out_dim
        self.lins = nn.ModuleList(layers)
        if len(dims) in self.skip:
            x_width += in_width
        self.lin_out = nn.Linear(x_width, out_dims)
        nn.init.zeros_(self.lin_out.weight)
        nn.init.zeros_(self.lin_out.bias)

    def forward(self, img):
        """img: (N, color_ch) flattened start maps → (N, out_dims). Counts
        N rows (``posmlp.rows.<output_type>``) under an open root."""
        count(f"{POSMLP_ROWS}.{self.output_type}", img.shape[0])
        with _FORWARD:
            coords = grid_coords(img.shape[0], img.device)
            pts = torch.cat([positional_embed(coords, self.multires), img], -1)
            x = pts
            for layer, lin in enumerate(self.lins):
                if layer in self.skip:
                    x = torch.cat([x, pts], dim=-1)
                x = torch.sin(lin(x))
            if len(self.lins) in self.skip:
                x = torch.cat([x, pts], dim=-1)
            x = self.lin_out(x)
            if self.output_type == "envmap":
                return torch.nn.functional.softplus(x)
            if self.output_type == "arm":
                return _straight_through_clamp(1.3 * torch.tanh(x) + img)
            if self.output_type == "armn":
                arm = _straight_through_clamp(1.3 * torch.tanh(x[..., 0:5])
                                              + img[..., 0:5])
                return torch.cat(
                    [arm, torch.tanh(x[..., 5:8] + img[..., 5:8])], dim=-1)
            if self.output_type == "normal":
                y = torch.tanh(x + img)
                return y / torch.clamp_min(
                    torch.linalg.vector_norm(y, dim=-1, keepdim=True), 1e-9)
            raise ValueError(f"unknown output_type {self.output_type}")


def make_envmap_net(generator: torch.Generator = None):
    """The envmap head."""
    return PosMLP(in_dims=5, out_dims=3, multires_view=2,
                  output_type="envmap", color_ch=3, generator=generator)


def make_brdf_net(output_type: str = "arm", generator: torch.Generator = None):
    """The material head."""
    if output_type == "arm":
        return PosMLP(in_dims=7, out_dims=5, multires_view=2,
                      output_type="arm", color_ch=5, generator=generator)
    if output_type == "armn":
        return PosMLP(in_dims=10, out_dims=8, multires_view=0,
                      output_type="armn", color_ch=8, generator=generator)
    raise ValueError(output_type)
