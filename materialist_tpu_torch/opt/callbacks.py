"""Host-side optimization callbacks: early stopping + best-state tracking
(counterpart of ``materialist_tpu/opt/callbacks.py``)."""

from __future__ import annotations

import copy
import os
from typing import Optional

import numpy as np
import torch

from materialist_tpu_torch.io import image as image_io


class EarlyStopping:
    """Stop after `patience` epochs without a `min_delta`-relative gain."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss: Optional[float] = None
        self.early_stop = False

    def __call__(self, loss: float) -> bool:
        if self.best_loss is None:
            self.best_loss = loss
        elif loss > self.best_loss * (1.0 - self.min_delta):
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_loss = loss
            self.counter = 0
        return self.early_stop


def _snap(x):
    return x.detach().clone() if torch.is_tensor(x) else x


class SaveBest:
    """Argmin-loss state of the optimization; ``save_results`` writes the
    best_results layout. Tensors are detached copies taken on
    improvement (torch tensors are mutable, unlike JAX arrays)."""

    KEYS = ("albedo", "roughness", "metallic", "normal", "envmap",
            "rendered_img")

    def __init__(self):
        self.best_loss = float("inf")
        self.best = {k: None for k in self.KEYS}
        self.best_net_params = None

    def update(self, loss: float, albedo, roughness, metallic, normal,
               envmap, rendered_img, net_params=None):
        if loss < self.best_loss:
            self.best_loss = loss
            self.best = {
                "albedo": _snap(albedo), "roughness": _snap(roughness),
                "metallic": _snap(metallic), "normal": _snap(normal),
                "envmap": _snap(envmap), "rendered_img": _snap(rendered_img),
            }
            if net_params is not None:
                self.best_net_params = copy.deepcopy(net_params)

    def get_best(self):
        out = dict(self.best)
        out["loss"] = self.best_loss
        return out

    def save_results(self, path: str):
        os.makedirs(path, exist_ok=True)
        names = {
            "envmap": "envmap.hdr", "albedo": "albedo.exr",
            "roughness": "roughness.exr", "metallic": "metallic.exr",
            "rendered_img": "rendered_img.exr", "normal": "normal.exr",
        }
        for key, fname in names.items():
            val = self.best.get(key)
            if val is not None:
                if torch.is_tensor(val):
                    val = val.detach().cpu().numpy()
                image_io.write(os.path.join(path, fname),
                               np.asarray(val, dtype=np.float32))
