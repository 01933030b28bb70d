"""Weight conversion from the JAX package's Flax parameter trees.

``posmlp_from_flax`` carries a PosMLP across: the Flax tree
``{"lin0": {"kernel": (in, out), "bias": (out,)}, ..., "lin_out": ...}``
given as numpy arrays becomes the state dict of
``models.posmlp.PosMLP`` (Linear ``weight`` is ``(out, in)``).
"""

from __future__ import annotations

import numpy as np
import torch


def posmlp_from_flax(params_np) -> dict:
    sd = {}
    hidden = sorted((k for k in params_np if k != "lin_out"),
                    key=lambda k: int(k[3:]))
    for i, name in enumerate(hidden):
        sd[f"lins.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(params_np[name]["kernel"]).T))
        sd[f"lins.{i}.bias"] = torch.from_numpy(
            np.asarray(params_np[name]["bias"]).copy())
    sd["lin_out.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(params_np["lin_out"]["kernel"]).T))
    sd["lin_out.bias"] = torch.from_numpy(
        np.asarray(params_np["lin_out"]["bias"]).copy())
    return sd
