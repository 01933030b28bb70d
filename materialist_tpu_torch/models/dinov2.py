"""DINOv2 ViT encoder (counterpart of ``materialist_tpu/models/dinov2.py``).

The architecture MaterialNet uses: vit_base by default (embed 768, depth
12, heads 12, patch 14, img 518), LayerScale, an MLP with exact GELU, no
register tokens. Attention is ``F.scaled_dot_product_attention`` (scale
1/√head_dim). The submodules carry the names of the reference's state
dict (``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ``blocks.{i}.ls1``,
...), so a reference checkpoint loads with ``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from materialist_tpu_torch.ops.resize import bicubic_scale

IMG_SIZE = 518             # the pos-embed's native grid is 37×37 patches
PATCH_SIZE = 14
MLP_RATIO = 4.0
INTERPOLATE_OFFSET = 0.1   # added to the grid before the bicubic scale


def init_(module: nn.Module, generator: torch.Generator = None):
    """Seeded initialisation of every Linear and convolution below
    ``module`` as Flax's defaults for the JAX package's layers: weights
    N(0, 1/fan_in) (LeCun, untruncated), biases 0. LayerNorm, LayerScale,
    the cls token and the pos-embed are set by their own modules."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = (w.shape[0] * w[0, 0].numel()
                          if isinstance(m, nn.ConvTranspose2d)
                          else w[0].numel())
                w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH_SIZE, stride=PATCH_SIZE)

    def forward(self, x):
        return self.proj(x)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)          # 3 × (B, heads, N, hd)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * MLP_RATIO))
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DINOv2(nn.Module):
    """vit_base defaults; returns selected intermediate layers' patch
    tokens."""

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, generator: torch.Generator = None):
        super().__init__()
        n_ref = (IMG_SIZE // PATCH_SIZE) ** 2
        self.patch_embed = PatchEmbed(embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, n_ref + 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        init_(self, generator)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x, out_layers: Sequence[int] = (2, 5, 8, 11)):
        """x: (B, 3, H, W) image. Returns the patch tokens (B, N, C) of
        each requested layer, final-LayerNormed."""
        b = x.shape[0]
        x = self.patch_embed(x)
        gh, gw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)                  # (B, gh·gw, C)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + self._interp_pos(gh, gw)
        outs = []
        want = set(out_layers)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in want:
                outs.append(self.norm(x)[:, 1:])
        return outs

    def _interp_pos(self, gh: int, gw: int):
        """Bicubic pos-embed interpolation; identity at the native grid."""
        pos = self.pos_embed
        n = pos.shape[1] - 1
        if gh * gw == n and gh == gw:
            return pos
        side = int(math.sqrt(n))
        patch = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
        patch = bicubic_scale(patch, ((gh + INTERPOLATE_OFFSET) / side,
                                      (gw + INTERPOLATE_OFFSET) / side))
        patch = patch.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([pos[:, :1], patch], dim=1)
