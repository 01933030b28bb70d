"""LPIPS perceptual distance, AlexNet backbone (counterpart of
``materialist_tpu/models/lpips.py``), NCHW.

The network of ``lpips.LPIPS(net='alex')``: a scaling layer ((x − shift)
/ scale), the torchvision AlexNet trunk tapped at its five ReLU outputs
(max-pools before the second and third convolutions), unit normalization
over channels (the norm clamped at 1e-10), the squared difference, a 1×1
"lin" projection with its weights clamped at 0, the spatial mean, and the
sum over the five layers. Inputs are RGB in [-1, 1]; ``normalize=True``
maps [0, 1] images there first.

The submodules carry the ``lpips`` package's names: ``scaling_layer``
(buffers ``shift``, ``scale``), ``net.slice{1..5}.{idx}`` with the
torchvision indices (convolutions at 0, 3, 6, 8, 10), and
``lin{0..4}.model.1.weight`` (shape (1, C, 1, 1)) aliased as
``lins.{i}``. So a full state dict of that package loads with
``load_state_dict``. The weights themselves are an input (``lpips_fn``
takes a module or a state dict, ``load_lpips`` a file): nothing is
downloaded.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from materialist_tpu_torch import device as device_mod

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
CHANNELS = (64, 192, 384, 256, 256)
# torchvision AlexNet features: (index, out_ch, kernel, stride, pad)
_CONVS = ((0, 64, 11, 4, 2), (3, 192, 5, 1, 2), (6, 384, 3, 1, 1),
          (8, 256, 3, 1, 1), (10, 256, 3, 1, 1))


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None,
                                                           None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None,
                                                           None])

    def forward(self, x):
        return (x - self.shift) / self.scale


class AlexFeatures(nn.Module):
    """The AlexNet trunk in five slices, each ending at a ReLU tap."""

    def __init__(self):
        super().__init__()
        cin = 3
        for k, (idx, cout, ker, stride, pad) in enumerate(_CONVS):
            layers = OrderedDict()
            if k in (1, 2):                 # max-pool before conv2, conv3
                layers[str(idx - 1)] = nn.MaxPool2d(3, 2)
            layers[str(idx)] = nn.Conv2d(cin, cout, ker, stride, pad)
            layers[str(idx + 1)] = nn.ReLU()
            setattr(self, f"slice{k + 1}", nn.Sequential(layers))
            cin = cout

    def forward(self, x):
        taps = []
        for k in range(5):
            x = getattr(self, f"slice{k + 1}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(cin, 1, 1,
                                                           bias=False))


class LPIPS(nn.Module):
    """``lpips.LPIPS(net='alex', spatial=False)``'s forward: (B,) distances
    of two (B, 3, H, W) batches. Kept in eval mode (its dropout is off)."""

    def __init__(self):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = AlexFeatures()
        for i, c in enumerate(CHANNELS):
            setattr(self, f"lin{i}", NetLinLayer(c))
        self.lins = nn.ModuleList(getattr(self, f"lin{i}")
                                  for i in range(5))
        self.eval()

    def forward(self, x, y, normalize: bool = False):
        if normalize:
            x = 2.0 * x - 1.0
            y = 2.0 * y - 1.0
        fx = self.net(self.scaling_layer(x))
        fy = self.net(self.scaling_layer(y))
        total = 0.0
        for a, b, lin in zip(fx, fy, self.lins):
            a = a / torch.clamp_min(
                torch.linalg.vector_norm(a, dim=1, keepdim=True), 1e-10)
            b = b / torch.clamp_min(
                torch.linalg.vector_norm(b, dim=1, keepdim=True), 1e-10)
            w = torch.clamp_min(lin.model[1].weight, 0.0)    # (1, C, 1, 1)
            val = torch.sum((a - b) ** 2 * w, dim=1)
            total = total + val.mean(dim=(1, 2))
        return total


def conv_keys():
    """The trunk's five convolutions as state-dict prefixes."""
    return [f"net.slice{k + 1}.{c[0]}" for k, c in enumerate(_CONVS)]


def required_keys() -> set:
    """The state-dict keys the forward reads (the trunk and ``lin{i}``);
    the scaling buffers and the ``lins`` aliases may be absent."""
    return ({f"lin{i}.model.1.weight" for i in range(5)}
            | {p + s for p in conv_keys() for s in (".weight", ".bias")})


def lpips_fn(source, device=None):
    """``perceptual_fn(pred, target)`` for ``models.train`` from an
    ``LPIPS`` module or a state dict of the ``lpips`` package (the AlexNet
    trunk included): the mean LPIPS of (B, 3, H, W) or (3, H, W) maps in
    [0, 1]. The net (a given module itself, put in eval mode) is frozen
    and lives on ``device`` (the card unless the CPU is asked for)."""
    dev = device_mod.resolve(device)
    if isinstance(source, LPIPS):
        model = source
    else:
        missing = required_keys() - set(source)
        if missing:
            raise KeyError(f"LPIPS state dict lacks {sorted(missing)}")
        model = LPIPS()
        model.load_state_dict(source, strict=False)
    model.to(dev).eval().requires_grad_(False)

    def perceptual_fn(pred, target):
        if pred.ndim == 3:
            pred, target = pred[None], target[None]
        return torch.mean(model(pred, target, normalize=True))

    return perceptual_fn


def load_lpips(weights_path: str, device=None):
    """``lpips_fn`` of the state dict saved at ``weights_path``."""
    return lpips_fn(torch.load(weights_path, map_location="cpu",
                               weights_only=True), device)
