"""State carried across from the JAX package, given as numpy arrays.

``posmlp_from_flax`` carries a PosMLP: the Flax tree
``{"lin0": {"kernel": (in, out), "bias": (out,)}, ..., "lin_out": ...}``
becomes the state dict of ``models.posmlp.PosMLP`` (Linear ``weight`` is
``(out, in)``). ``gbuffer_from_arrays`` and ``materials_from_arrays``
carry a scene: the fields of the JAX package's ``GBuffer`` and
``Materials`` (same names, same layouts) become the port's containers on a
device.

MaterialNet comes by three routes, each ending in the state dict of
``models.dpt.MaterialNet``:

- ``matnet_from_flax``: a Flax parameter tree of the JAX package's
  MaterialNet (numpy leaves), e.g. from ``load_checkpoint`` on the
  native ``.npz`` checkpoint. Layout rules, the inverse of the JAX
  package's torch→Flax ones:

      Flax Conv kernel (kh,kw,in,out)       → Conv2d weight (out,in,kh,kw)
      block-upsample kernel (kh,kw,in,out)  → ConvTranspose2d (in,out,kh,kw)
      Dense kernel (in,out)                 → Linear weight (out,in)
      LayerNorm scale/bias                  → weight/bias

- ``from_reference``: the reference's own state dict, whose names the
  port's modules carry; only its dead keys are dropped.
- ``load_matnet_params``: a reference ``.pth`` from an explicit path or
  ``$MATNET_WEIGHTS`` (the published checkpoint is HuggingFace
  ``Lez/MatNet``, ``matnet_weights.pth``; nothing is downloaded).

``matnet_to_flax`` goes back: the port's state dict to the JAX package's
Flax tree, which ``models.train.save_checkpoint`` writes in the native
``.npz`` layout so that both packages load what the port trains.
``lpips_from_flax`` carries the JAX package's LPIPS parameters to
``models.lpips.LPIPS``.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from materialist_tpu_torch.models.lpips import LPIPS, conv_keys
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


# Flax module name → the port's (= the reference's) submodule path
_MATNET_RENAMES = (
    (re.compile(r"^block(\d+)$"), r"blocks.\1"),
    (re.compile(r"^project(\d)$"), r"projects.\1"),
    (re.compile(r"^resize(\d)$"), r"resize_layers.\1"),
    (re.compile(r"^(layer\d_rn|refinenet\d|output_conv1)$"), r"scratch.\1"),
    (re.compile(r"^output_conv2_(\d)$"), r"scratch.output_conv2.\1"),
    (re.compile(r"^rcu(\d)$"), r"resConfUnit\1"),
    (re.compile(r"^patch_embed$"), "patch_embed.proj"),
    (re.compile(r"^(kernel|scale)$"), "weight"),
)
_BLOCK_UPSAMPLE = re.compile(r"^resize[01]$")


def _flatten(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def _rename(part: str) -> str:
    for pat, rep in _MATNET_RENAMES:
        if pat.match(part):
            return pat.sub(rep, part)
    return part


def matnet_from_flax(tree) -> dict:
    """The JAX package's MaterialNet parameters (nested dict of numpy
    arrays) → the state dict of ``models.dpt.MaterialNet``."""
    sd = {}
    for path, leaf in _flatten(tree):
        a = np.array(leaf, np.float32)
        if path[-1] == "kernel" and a.ndim == 4:
            a = a.transpose((2, 3, 0, 1) if _BLOCK_UPSAMPLE.match(path[-2])
                            else (3, 2, 0, 1))
        elif path[-1] == "kernel" and a.ndim == 2:
            a = a.T
        name = ".".join(_rename(p) for p in path)
        sd[name] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


# the port's two-part module paths that are one Flax module name
_FLAX_JOINS = {"blocks": "block{}", "projects": "project{}",
               "resize_layers": "resize{}", "output_conv2": "output_conv2_{}"}
_RCU = re.compile(r"^resConfUnit(\d)$")


def _flax_path(key: str, ndim: int):
    parts, out, i = key.split("."), [], 0
    while i < len(parts):
        p = parts[i]
        if p in _FLAX_JOINS:
            out.append(_FLAX_JOINS[p].format(parts[i + 1]))
            i += 2
            continue
        if p == "patch_embed":           # patch_embed.proj → patch_embed
            out.append(p)
            i += 2
            continue
        if p != "scratch":
            out.append(_RCU.sub(r"rcu\1", p))
        i += 1
    if out[-1] == "weight":
        out[-1] = "kernel" if ndim >= 2 else "scale"
    return out


def matnet_to_flax(sd) -> dict:
    """The state dict of ``models.dpt.MaterialNet`` → the JAX package's
    MaterialNet parameters (nested dict of float32 numpy arrays): the
    inverse of ``matnet_from_flax``. Dead reference keys are skipped."""
    tree = {}
    for key, t in sd.items():
        if _is_dead(key):
            continue
        a = t.detach().cpu().numpy().astype(np.float32)
        path = _flax_path(key, a.ndim)
        if path[-1] == "kernel" and a.ndim == 4:
            a = a.transpose((2, 3, 0, 1) if _BLOCK_UPSAMPLE.match(path[-2])
                            else (2, 3, 1, 0))
        elif path[-1] == "kernel" and a.ndim == 2:
            a = a.T
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return tree


def lpips_from_flax(params) -> dict:
    """The JAX package's LPIPS parameters (``{"net": {"conv{i}": {kernel,
    bias}}, "lin{i}": (C,)}``) → the full state dict of
    ``models.lpips.LPIPS``, the scaling buffers and ``lins`` aliases
    included, so that it loads strictly."""
    sd = dict(LPIPS().state_dict())
    for i, prefix in enumerate(conv_keys()):
        conv = params["net"][f"conv{i}"]
        sd[prefix + ".weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1)))
        sd[prefix + ".bias"] = torch.from_numpy(
            np.array(conv["bias"], np.float32))
    for i in range(5):
        w = torch.from_numpy(np.array(params[f"lin{i}"], np.float32))
        sd[f"lin{i}.model.1.weight"] = sd[f"lins.{i}.model.1.weight"] = \
            w.reshape(1, -1, 1, 1)
    return sd


def _is_dead(key: str) -> bool:
    """Keys of the reference that no computation reads: DINOv2's mask
    token (masked pre-training only) and the residual unit of refinenet4,
    which receives a single input."""
    return key == "pretrained.mask_token" or (
        ".scratch.refinenet4.resConfUnit1." in key)


def from_reference(sd) -> dict:
    """The reference's MaterialNet state dict → the port's: the same
    names, float32, without the dead keys."""
    return {k: torch.as_tensor(v).detach().to(torch.float32)
            for k, v in sd.items() if not _is_dead(k)}


def load_matnet_params(weights_path: str = None) -> dict:
    """Load a reference ``matnet_weights.pth`` as the port's state dict.

    Resolution order: explicit path → ``$MATNET_WEIGHTS``; without either
    it raises ``FileNotFoundError`` (no download is attempted).
    """
    path = weights_path or os.environ.get("MATNET_WEIGHTS")
    if path is None:
        raise FileNotFoundError(
            "MaterialNet weights unavailable: set MATNET_WEIGHTS to a "
            "local matnet_weights.pth")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return from_reference(sd)


def load_checkpoint(path: str):
    """Read the JAX package's native ``.npz`` checkpoint: flat keys such
    as ``['pretrained']['block0']['attn']['qkv']['kernel']``, float16
    leaves, ``__step__`` and an optional JSON ``__config__``. Returns
    (nested params of float32 numpy arrays, step, config or None); list
    values of the config become tuples, ready for ``MaterialNet(**cfg)``.
    """
    params, step, config = {}, 0, None
    with np.load(path) as data:
        for k in data.files:
            if k == "__step__":
                step = int(data[k])
                continue
            if k == "__config__":
                config = {c: tuple(v) if isinstance(v, list) else v
                          for c, v in json.loads(
                              bytes(data[k]).decode()).items()}
                continue
            keys = re.findall(r"\['([^']+)'\]", k)
            node = params
            for part in keys[:-1]:
                node = node.setdefault(part, {})
            a = data[k]
            node[keys[-1]] = (a.astype(np.float32)
                              if a.dtype == np.float16 else a)
    return params, step, config
