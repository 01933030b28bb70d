"""Transparency / translucency editing CLI (counterpart of
``materialist_tpu/cli/trans_edit.py``).

Inside the mask the object becomes glass-like: albedo 0.7 (unless
--keep_albedo_color), roughness 0.3, metallic 0, rendered with the
transparent BSDF (``render/bsdf.py::transparent``), whose transmission
fetches the background at doubly-refracted screen coordinates. The render
runs on the card unless ``--device cpu`` is given.

Usage: python -m materialist_tpu_torch.cli.trans_edit --save_name NAME
           [--ior 1.2] [--specTrans 0.4] [--keep_albedo_color]
           [--env_path path.hdr] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from materialist_tpu_torch import config as gconfig
from materialist_tpu_torch import device as device_mod
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.cli import common
from materialist_tpu_torch.io import image as image_io
from materialist_tpu_torch.render import bsdf as bsdf_mod
from materialist_tpu_torch.render import forward
from materialist_tpu_torch.render.scene import Materials, load_best_results


def transparency_edit(save_name, ior, keep_albedo_color, spec_trans,
                      env_path=None, n_iter=10, spp=64, save_path=None,
                      device=None):
    dev = device_mod.resolve(device)
    scene_dir = os.path.join(gconfig.OUT_DIR, save_name)
    mat_dir = os.path.join(scene_dir, "best_results")
    mat = load_best_results(mat_dir)
    if "mask" not in mat:
        raise FileNotFoundError(f"{mat_dir}/mask.png required for "
                                "transparency editing")
    if "bg" not in mat:
        raise FileNotFoundError(f"{mat_dir}/bg.png required for "
                                "transparency editing")
    env_path = common.resolve_envmap(save_name, env_path)
    envmap = image_io.read(env_path)
    env_id = os.path.basename(env_path)[:-4]

    mask = mat["mask"]
    if not keep_albedo_color:
        mat["albedo"] = np.where(mask[..., None], 0.7, mat["albedo"])
    mat["roughness"] = np.where(mask[..., None], 0.3, mat["roughness"])
    mat["metallic"] = np.where(mask[..., None], 0.0, mat["metallic"])

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    gbuf = common.load_scene_gbuffer(scene_dir, device=dev)
    cam = Camera(mat["albedo"].shape[0], mat["albedo"].shape[1])
    mats = Materials(t(mat["albedo"]), t(mat["roughness"]),
                     t(mat["metallic"]), t(mat["normal"]))
    n = mats.albedo.shape[0] * mats.albedo.shape[1]
    refract_distance = 100.0 if keep_albedo_color else 1.0
    bsdf = bsdf_mod.transparent(
        mats, t(mat["bg"]), torch.as_tensor(np.asarray(mask), device=dev),
        float(spec_trans), float(ior), cam, gbuf.position.reshape(n, 3),
        refract_distance=refract_distance)

    img = forward.render_averaged(gbuf, cam, mats, envmap, n_iter=n_iter,
                                  spp=spp, denoise=False, bsdf=bsdf)
    albedo_flag = "wA" if keep_albedo_color else "woA"
    stem = f"mi_trans_{ior}_{albedo_flag}_{spec_trans}_{save_name}_{env_id}"
    out_dir = os.path.join(save_path or gconfig.OUT_DIR, save_name)
    os.makedirs(out_dir, exist_ok=True)
    image_io.write(os.path.join(out_dir, f"{stem}.exr"), img)
    # the PNG takes the linear image, as the JAX package writes it
    image_io.write(os.path.join(out_dir, f"{stem}.png"), img)
    print("Wrote file to", os.path.join(out_dir, f"{stem}.png"))
    return img


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Render a scene with transparency editing")
    p.add_argument("--save_name", type=str, required=True)
    p.add_argument("--ior", type=float, default=1.2)
    p.add_argument("--keep_albedo_color", action="store_true")
    p.add_argument("--specTrans", type=float, default=0.4)
    p.add_argument("--env_path", type=str, default=None)
    p.add_argument("--n_iter", type=int, default=10)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    transparency_edit(a.save_name, a.ior, a.keep_albedo_color, a.specTrans,
                      env_path=a.env_path, n_iter=a.n_iter, spp=a.spp,
                      device=a.device)


if __name__ == "__main__":
    main()
