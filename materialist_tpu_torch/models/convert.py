"""State carried across from the JAX package, given as numpy arrays.

``posmlp_from_flax`` carries a PosMLP: the Flax tree
``{"lin0": {"kernel": (in, out), "bias": (out,)}, ..., "lin_out": ...}``
becomes the state dict of ``models.posmlp.PosMLP`` (Linear ``weight`` is
``(out, in)``). ``gbuffer_from_arrays`` and ``materials_from_arrays``
carry a scene: the fields of the JAX package's ``GBuffer`` and
``Materials`` (same names, same layouts) become the port's containers on a
device.
"""

from __future__ import annotations

import numpy as np
import torch

from materialist_tpu_torch.render.scene import GBuffer, Materials


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


def _f32(x, device):
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def gbuffer_from_arrays(position, normal_geo, dist, wo, valid,
                        device=None) -> GBuffer:
    return GBuffer(_f32(position, device), _f32(normal_geo, device),
                   _f32(dist, device), _f32(wo, device),
                   torch.as_tensor(np.array(valid, dtype=bool),
                                   device=device))


def materials_from_arrays(albedo, roughness, metallic, normal,
                          device=None) -> Materials:
    return Materials(_f32(albedo, device), _f32(roughness, device),
                     _f32(metallic, device), _f32(normal, device))
