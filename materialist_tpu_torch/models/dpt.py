"""MaterialNet: DINOv2 encoder + two DPT heads, depth and material
(counterpart of ``materialist_tpu/models/dpt.py``), NCHW.

Four intermediate ViT levels are projected to a conv pyramid (×4, ×2, ×1,
÷2), refined through four FeatureFusionBlocks and decoded to 1-channel
ReLU depth or 8-channel material: ReLU(albedo, roughness, metallic) ⧺
tanh + L2-normalised normal. The ×4 and ×2 steps are ConvTranspose2d with
stride equal to the kernel.

The submodules carry the names of the reference's state dict
(``depth_head.projects.{i}``, ``depth_head.resize_layers.{0,1,3}``,
``depth_head.scratch.layer{i}_rn``, ``scratch.refinenet{i}.resConfUnit{1,2}
.conv{1,2}``, ``scratch.output_conv2.{0,2}``, ...). ``refinenet4`` takes
one input and so has no ``resConfUnit1``; ``models.convert.from_reference``
drops that unit's keys and ``pretrained.mask_token``, by name.

``MaterialNet.forward`` opens the spans ``matnet.encoder``,
``matnet.depth_head`` and ``matnet.material_head`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from materialist_tpu_torch.models.dinov2 import PATCH_SIZE, DINOv2, init_
from materialist_tpu_torch.ops.resize import bilinear_align_corners
from materialist_tpu_torch.utils.profiling import span

_ENCODER = span("matnet.encoder")
_DEPTH_HEAD = span("matnet.depth_head")
_MATERIAL_HEAD = span("matnet.material_head")


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        y = self.conv1(F.relu(x))
        return x + self.conv2(F.relu(y))


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, with_residual: bool = True):
        super().__init__()
        if with_residual:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, res=None, size=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[-2] * 2, x.shape[-1] * 2)
        return self.out_conv(bilinear_align_corners(x, size))


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int],
                 out_ch: int):
        super().__init__()
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(out_channels[i], features, 3, padding=1,
                              bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}",
                    FeatureFusionBlock(features, with_residual=i != 4))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, out_ch, 1))


class DPTHead(nn.Module):
    def __init__(self, in_channels: int, features: int = 128,
                 out_channels: Sequence[int] = (96, 192, 384, 768),
                 output_type: str = "depth",
                 generator: torch.Generator = None):
        super().__init__()
        self.output_type = output_type
        oc = tuple(out_channels)
        self.projects = nn.ModuleList(
            nn.Conv2d(in_channels, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1)])
        self.scratch = _Scratch(features, oc,
                                1 if output_type == "depth" else 8)
        init_(self, generator)

    def forward(self, levels, patch_h: int, patch_w: int):
        """levels: 4 × (B, N, C) patch tokens. Returns (B, ch, 14·ph,
        14·pw)."""
        rn = []
        for i, tokens in enumerate(levels):
            b, _, c = tokens.shape
            x = tokens.transpose(1, 2).reshape(b, c, patch_h, patch_w)
            x = self.resize_layers[i](self.projects[i](x))
            rn.append(getattr(self.scratch, f"layer{i + 1}_rn")(x))
        s = self.scratch
        path4 = s.refinenet4(rn[3], size=rn[2].shape[-2:])
        path3 = s.refinenet3(path4, rn[2], size=rn[1].shape[-2:])
        path2 = s.refinenet2(path3, rn[1], size=rn[0].shape[-2:])
        path1 = s.refinenet1(path2, rn[0])
        x = s.output_conv1(path1)
        x = bilinear_align_corners(x, (patch_h * PATCH_SIZE,
                                         patch_w * PATCH_SIZE))
        x = s.output_conv2(x)
        if self.output_type == "depth":
            return F.relu(x)
        arm = F.relu(x[:, :5])
        normal = torch.tanh(x[:, 5:8])
        normal = normal / torch.clamp_min(
            torch.linalg.vector_norm(normal, dim=1, keepdim=True), 1e-6)
        return torch.cat([arm, normal], dim=1)


class MaterialNet(nn.Module):
    """Defaults are the checkpoint-pinned vit-b; the in-repo self-trained
    checkpoint stores its smaller encoder's config beside its weights."""

    def __init__(self, features: int = 128,
                 out_channels: Sequence[int] = (96, 192, 384, 768),
                 layer_idx: Sequence[int] = (2, 5, 8, 11),
                 embed_dim: int = 768, enc_depth: int = 12,
                 num_heads: int = 12, generator: torch.Generator = None):
        super().__init__()
        self.features = features
        self.out_channels = tuple(out_channels)
        self.layer_idx = tuple(layer_idx)
        self.embed_dim, self.enc_depth = embed_dim, enc_depth
        self.num_heads = num_heads
        self.pretrained = DINOv2(embed_dim=embed_dim, depth=enc_depth,
                                 num_heads=num_heads, generator=generator)
        self.depth_head = DPTHead(embed_dim, features, out_channels, "depth",
                                  generator=generator)
        self.material_head = DPTHead(embed_dim, features, out_channels,
                                     "material", generator=generator)

    def encoder_config(self) -> dict:
        """The constructor's keyword arguments (the generator aside): what
        a checkpoint stores so that inference rebuilds this net."""
        return {"features": self.features,
                "out_channels": self.out_channels,
                "layer_idx": self.layer_idx,
                "embed_dim": self.embed_dim,
                "enc_depth": self.enc_depth,
                "num_heads": self.num_heads}

    def forward(self, x):
        """x: (B, 3, H, W) image, H and W multiples of 14. Returns a dict
        of (B, ch, H, W) maps."""
        ph, pw = x.shape[-2] // PATCH_SIZE, x.shape[-1] // PATCH_SIZE
        with _ENCODER:
            tokens = self.pretrained(x, self.layer_idx)
        with _DEPTH_HEAD:
            depth = F.relu(self.depth_head(tokens, ph, pw))
        with _MATERIAL_HEAD:
            armn = self.material_head(tokens, ph, pw)
        return {"depth": depth, "albedo": armn[:, 0:3],
                "roughness": armn[:, 3:4], "metallic": armn[:, 4:5],
                "normal": armn[:, 5:8]}

