"""Forward rendering / relighting CLI (counterpart of
``materialist_tpu/cli/render_final.py``).

Modes: ``real`` re-renders the optimized scene under its own or a new
envmap, with optional masked edits; ``oi`` renders with inserted objects
(``oi.ply`` glass, ``oi2.ply`` diffuse, in the scene dir); ``rolling``
writes the rotating-envmap animation. The renders run on the card unless
``--device cpu`` is given.

Usage: python -m materialist_tpu_torch.cli.render_final --save_name indoor
           --mode real [--env_path path.hdr] [--input_path dir]
           [--save_path dir] [--frames 36] [--rotation_step 10]
           [--device cuda]
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
from materialist_tpu_torch.render import edits as edits_mod
from materialist_tpu_torch.render import forward
from materialist_tpu_torch.render.scene import Materials, load_best_results


def _load_scene(save_name, input_path, dev):
    scene_dir = os.path.join(input_path or gconfig.OUT_DIR, save_name)
    mat = load_best_results(os.path.join(scene_dir, "best_results"))
    gbuf = common.load_scene_gbuffer(scene_dir, device=dev)
    cam = Camera(mat["albedo"].shape[0], mat["albedo"].shape[1])
    return scene_dir, mat, gbuf, cam


def _materials(mat, dev):
    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
    return Materials(t(mat["albedo"]), t(mat["roughness"]),
                     t(mat["metallic"]), t(mat["normal"]))


def _write_pair(out_dir, stem, img):
    os.makedirs(out_dir, exist_ok=True)
    image_io.write(os.path.join(out_dir, f"{stem}.exr"), img)
    image_io.write(os.path.join(out_dir, f"{stem}.png"),
                   np.clip(img, 0, 1) ** (1 / 2.2), linear_input=False)
    print("Wrote file to", os.path.join(out_dir, f"{stem}.png"))


def render_real(save_name, env_path=None, edit=None, n_iter=10,
                input_path=None, save_path=None, spp=64, device=None):
    """--mode real: the scene under an envmap, with masked edits."""
    dev = device_mod.resolve(device)
    edit = edit or {"albedo": None, "roughness": None, "metallic": None}
    _, mat, gbuf, cam = _load_scene(save_name, input_path, dev)
    env_path = common.resolve_envmap(save_name, env_path, input_path)
    envmap = image_io.read(env_path)
    env_id = os.path.basename(env_path)[:-4]

    use_mesh_normal = "mn" not in save_name
    print("Use Mesh Normal" if use_mesh_normal else "Use Optimized Normal")
    edit_flag = edits_mod.apply_edits(mat, edit)
    img = forward.render_averaged(gbuf, cam, _materials(mat, dev), envmap,
                                  n_iter=n_iter, spp=spp)
    _write_pair(os.path.join(save_path or gconfig.OUT_DIR, save_name),
                f"mi_{save_name}_{env_id}_{edit_flag}", img)
    return img


def render_io(save_name, env_path=None, input_path=None, save_path=None,
              n_iter=10, spp=32, device=None):
    """--mode oi: object insertion."""
    from materialist_tpu_torch.render import insertion
    dev = device_mod.resolve(device)
    scene_dir, mat, gbuf, cam = _load_scene(save_name, input_path, dev)
    env_path = common.resolve_envmap(save_name, env_path, input_path,
                                     prefer_opt=True)
    envmap = image_io.read(env_path)
    env_id = os.path.basename(env_path)[:-4]
    img = insertion.render_insert(scene_dir, mat, gbuf, cam, envmap,
                                  n_iter=n_iter, spp=spp)
    _write_pair(os.path.join(save_path or gconfig.OUT_DIR, save_name),
                f"mi_oi_{save_name}_{env_id}", img)
    return img


def render_rolling(save_name, env_path=None, frames=36, rotation_step=10.0,
                   edit=None, n_iter=1, input_path=None, save_path=None,
                   device=None):
    """--mode rolling: the rotating-envmap animation."""
    dev = device_mod.resolve(device)
    edit = edit or {}
    _, mat, gbuf, cam = _load_scene(save_name, input_path, dev)
    env_path = common.resolve_envmap(save_name, env_path, input_path)
    envmap = image_io.read(env_path)
    env_id = os.path.basename(env_path)[:-4]
    edit_flag = edits_mod.apply_edits(mat, edit) if edit else ""
    out_dir = os.path.join(save_path or gconfig.OUT_DIR, save_name)
    os.makedirs(out_dir, exist_ok=True)
    return forward.render_rolling(gbuf, cam, _materials(mat, dev), envmap,
                                  out_dir, save_name, env_id, frames=frames,
                                  rotation_step=rotation_step, n_iter=n_iter,
                                  edit_flag=edit_flag)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="re-render / relight an optimized scene")
    p.add_argument("--env_path", default=None, type=str)
    p.add_argument("--save_name", required=True, type=str)
    p.add_argument("--mode", required=True, type=str,
                   choices=["real", "oi", "rolling"])
    p.add_argument("--input_path", default=None, type=str)
    p.add_argument("--save_path", default=None, type=str)
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--rotation_step", type=float, default=10.0)
    p.add_argument("--n_iter", type=int, default=10)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    edit = {"albedo": None, "roughness": None, "metallic": None}
    if args.mode == "real":
        render_real(args.save_name, args.env_path, edit=edit,
                    n_iter=args.n_iter, input_path=args.input_path,
                    save_path=args.save_path, spp=args.spp,
                    device=args.device)
    elif args.mode == "oi":
        render_io(args.save_name, args.env_path,
                  input_path=args.input_path, save_path=args.save_path,
                  n_iter=args.n_iter, device=args.device)
    elif args.mode == "rolling":
        render_rolling(args.save_name, args.env_path, frames=args.frames,
                       rotation_step=args.rotation_step, edit=edit,
                       n_iter=args.n_iter, input_path=args.input_path,
                       save_path=args.save_path, device=args.device)


if __name__ == "__main__":
    main()
