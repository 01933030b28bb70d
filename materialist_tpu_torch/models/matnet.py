"""MaterialNet inference: image → material maps (counterpart of
``materialist_tpu/models/matnet.py``).

An aspect-preserving lower-bound resize to multiples of 14 (bicubic, cv2
``INTER_CUBIC`` semantics), the forward, and a bilinear align-corners
restore to the input resolution, all on the model's device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from materialist_tpu_torch import device as device_mod
from materialist_tpu_torch.models.convert import (load_checkpoint,
                                                  load_matnet_params,
                                                  matnet_from_flax)
from materialist_tpu_torch.models.dinov2 import PATCH_SIZE
from materialist_tpu_torch.models.dpt import MaterialNet
from materialist_tpu_torch.ops.resize import (bicubic_resize,
                                              bilinear_align_corners)


def lower_bound_size(h: int, w: int, target: int = 518):
    """The 'lower_bound' size: aspect kept, each side ≥ ``target`` and
    rounded to a multiple of the patch size."""
    scale = max(target / h, target / w)

    def constrain(x):
        return max(int(np.round(x * scale / PATCH_SIZE) * PATCH_SIZE),
                   target)

    return constrain(h), constrain(w)


def resize_lower_bound(x, target: int = 518):
    """x (B, C, H, W) → bicubically resized to ``lower_bound_size``."""
    return bicubic_resize(x, lower_bound_size(x.shape[-2], x.shape[-1],
                                              target))


class MatNetInference:
    """Holds the net on its device and runs ``infer_image``.

    ``params``: a state dict of ``MaterialNet``; else ``weights_path``:
    the JAX package's native ``.npz`` checkpoint (its config rebuilds the
    net) or a reference ``.pth`` (``load_matnet_params``). ``device``:
    the card unless the CPU is asked for.
    """

    def __init__(self, params=None, weights_path: str = None, net=None,
                 device=None):
        self.device = device_mod.resolve(device)
        if params is None and weights_path and weights_path.endswith(".npz"):
            tree, _, cfg = load_checkpoint(weights_path)
            params = matnet_from_flax(tree)
            if cfg is not None and net is None:
                net = MaterialNet(**cfg)
        elif params is None:
            params = load_matnet_params(weights_path)
        self.net = net or MaterialNet()
        self.net.load_state_dict(params)
        self.net.to(self.device).eval()

    def infer_image(self, raw_image: np.ndarray,
                    input_size: int = 518) -> dict:
        """raw_image (H, W, 3) float [0, 1] (or uint8) → dict of numpy
        maps at (H, W); 1-channel maps come squeezed to (H, W)."""
        if raw_image.dtype == np.uint8:
            raw_image = raw_image.astype(np.float32) / 255.0
        h, w = raw_image.shape[:2]
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(raw_image, np.float32),
                                device=self.device)
            img = resize_lower_bound(x.permute(2, 0, 1)[None], input_size)
            if float(img.mean()) >= 10:
                warnings.warn("Pixel intensity too high; dividing by 255.")
                img = img / 255.0
            out = self.net(img)
            maps = {}
            for k, v in out.items():
                arr = bilinear_align_corners(v, (h, w))[0].permute(1, 2, 0)
                arr = arr.cpu().numpy()
                maps[k] = arr[..., 0] if arr.shape[-1] == 1 else arr
        return maps
