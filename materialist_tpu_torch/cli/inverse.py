"""Single-image inverse rendering CLI (counterpart of
``materialist_tpu/cli/inverse.py``).

Load + center-crop-resize the input to 512², sRGB→linear for PNG/JPG,
predict albedo, roughness, metallic, normal and depth with MaterialNet,
write the prediction files + config.json, build the depth mesh PLY if
absent, then run the alternating envmap/material optimization, all on the
card. The PLY goes where the JAX package puts it,
``os.path.join(output_dir, f"{save_name}.ply")``: ``output_dir/NAME.ply``
for a plain name, but ``/abs/OUT.ply`` beside the output dir for an
absolute ``--save_name /abs/OUT`` and ``output_dir/a/b.ply`` for a nested
``a/b``; a mesh already there is not rebuilt. ``--opt_src skip --opt_order skip`` resumes instead: it reloads
best_results/ and depthPred.exr from the output dir and predicts nothing.

Usage: python -m materialist_tpu_torch.cli.inverse --img_inverse_path
           img.exr --save_name NAME --opt_src a [--opt_order rm a]
           [--weights runs/matnet_r5/matnet_scratch.npz | matnet.pth]
           [--use_mask] [--opt_env_from 2] [--save_path DIR]
           [--num_epochs N] [--spp 64] [--frame_every 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import numpy as np

from materialist_tpu_torch import config as gconfig
from materialist_tpu_torch import device as device_mod
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.cli.common import get_output_dir
from materialist_tpu_torch.geometry.mesh_recon import depth_file_to_mesh_ply
from materialist_tpu_torch.io import exr as exr_io
from materialist_tpu_torch.io import image as image_io
from materialist_tpu_torch.opt.loop import InverseOptions, optimize
from materialist_tpu_torch.render.scene import make_gbuffer


def inverse_image(img_inverse_path, save_name, opt_src, opt_order,
                  use_mask=False, opt_env_from=0, save_path=None,
                  model_name="pos_mlp", spp=64, num_epochs=None,
                  weights_path=None, frame_every=10, device=None):
    dev = device_mod.resolve(device)
    print(f"Inverse image {img_inverse_path}")
    output_dir = get_output_dir(save_name, save_path)
    os.makedirs(os.path.join(output_dir, "best_results"), exist_ok=True)

    raw = image_io.read(img_inverse_path)
    img = image_io.center_crop_and_resize(raw, (512, 512))
    if not img_inverse_path.endswith(".exr"):
        warnings.warn("PNG/JPG input assumed sRGB; converting to linear")
        img = np.clip(img, 0, 1) ** 2.2

    skip = opt_src == "skip" and list(opt_order) == ["skip"]
    if not skip:
        from materialist_tpu_torch.models.matnet import MatNetInference
        matnet = MatNetInference(weights_path=weights_path, device=dev)
        pred = matnet.infer_image(img)
        depth = pred["depth"].astype(np.float32)[..., None]
        mat = {
            "gt_image": img.astype(np.float32),
            "albedo": np.clip(pred["albedo"], 0, 1),
            "normal": pred["normal"],
            "roughness": np.clip(pred["roughness"][..., None], 0.07, 1),
            "metallic": np.clip(pred["metallic"][..., None], 0, 1),
        }

        for name, arr in (("albedoPred.exr", pred["albedo"]),
                          ("normalPred.exr", pred["normal"]),
                          ("roughnessPred.png", pred["roughness"]),
                          ("metallicPred.png", pred["metallic"]),
                          ("depthPred.exr", depth[..., 0]),
                          ("gt_image.exr", img), ("gt_image.png", img)):
            image_io.write(os.path.join(output_dir, name), arr)

        config = {
            "img_path": img_inverse_path, "save_name": save_name,
            "opt_src": opt_src, "opt_order": list(opt_order),
            "use_mask": use_mask, "opt_env_from": opt_env_from,
            "model_name": model_name,
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
            "image_size": list(img.shape[:2]), "spp": spp,
            "output_type": "armn" if "n" in str(opt_order) else "arm",
            "use_mesh_normal": not ("n" in str(opt_order)),
        }
        with open(os.path.join(output_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=4)
        print(f"Configuration saved to {output_dir}/config.json")
    else:
        print("Load Pre Opted Brdf")
        br = os.path.join(output_dir, "best_results")
        mat = {
            "albedo": np.clip(exr_io.read(os.path.join(br, "albedo.exr")),
                              0, 1),
            "roughness": np.clip(exr_io.read(
                os.path.join(br, "roughness.exr"))[..., :1], 0.07, 1),
            "metallic": np.clip(exr_io.read(
                os.path.join(br, "metallic.exr"))[..., :1], 0, 1),
            "normal": exr_io.read(os.path.join(br, "normal.exr")),
            "gt_image": img.astype(np.float32),
        }
        depth = exr_io.read(
            os.path.join(output_dir, "depthPred.exr"))[..., :1]

    if use_mask:
        mask_path = os.path.join(output_dir, "best_results", "mask.png")
        if os.path.exists(mask_path):
            m = image_io.read(mask_path)
            mat["mask"] = (m[..., 0] if m.ndim == 3 else m) > 0.5
        else:
            warnings.warn("No mask found; continuing without mask")
            use_mask = False

    mesh_path = os.path.join(output_dir, f"{save_name}.ply")
    mesh_mask_path = os.path.join(output_dir, "mesh_mask.png")
    mesh_mask = None
    if os.path.exists(mesh_mask_path):
        mm = image_io.read(mesh_mask_path)
        mesh_mask = (mm[..., 0] if mm.ndim == 3 else mm) > 0.5
    depth_np = depth[..., 0]
    flipped = 2 * depth_np.max() - depth_np
    if mesh_mask is not None:
        flipped = np.where(mesh_mask, 0.0, flipped)
    if not os.path.exists(mesh_path):
        nv, nf = depth_file_to_mesh_ply(flipped, mesh_path, min_angle=6.0)
        print(f"wrote {mesh_path} ({nv} verts, {nf} faces)")

    if opt_env_from > 1:
        envp = os.path.join(output_dir, "best_results", "envmap.hdr")
        if os.path.exists(envp):
            print(f"Load envmap from {envp}")
            mat["gt_envmap"] = image_io.read(envp)
        else:
            print(f"No envmap found in {envp}, will use envmap=1 instead")

    output_type = "armn" if "n" in str(opt_order) else "arm"
    use_mesh_normal = output_type == "arm"
    print("Use mesh normal" if use_mesh_normal else "Use normal map")

    cam = Camera(512, 512)
    gbuf = make_gbuffer(depth[..., 0], cam, flip_depth=True, mask=mesh_mask,
                        device=dev)
    opts = InverseOptions(
        opt_src=opt_src, opt_order=tuple(opt_order),
        model_name=model_name, use_mask=use_mask,
        opt_env_from=opt_env_from, output_type=output_type,
        use_mesh_normal=use_mesh_normal, spp=spp,
        num_epochs=num_epochs or gconfig.NUM_EPOCHS,
        frame_every=frame_every)
    return optimize(gbuf, cam, mat, output_dir, opts, device=dev)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="inverse a given image")
    p.add_argument("--img_inverse_path", required=True, type=str)
    p.add_argument("--save_name", required=True, type=str)
    p.add_argument("--opt_src", required=True, type=str, default="arm",
                   help="which predicted maps to trust (a/r/m tokens)")
    p.add_argument("--opt_order", required=False, nargs="+",
                   default=["arm"])
    p.add_argument("--use_mask", action="store_true")
    p.add_argument("--opt_env_from", required=False, default=0, type=int)
    p.add_argument("--save_path", required=False, default=None, type=str)
    p.add_argument("--model_name", required=False, default="pos_mlp",
                   choices=["pos_mlp", "none"])
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--weights", type=str, default=None,
                   help="MaterialNet weights: a native .npz checkpoint "
                        "(e.g. runs/matnet_r5/matnet_scratch.npz) or a "
                        "reference matnet_weights.pth (default: "
                        "$MATNET_WEIGHTS)")
    p.add_argument("--frame_every", type=int, default=10)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    return inverse_image(a.img_inverse_path, a.save_name, a.opt_src,
                         a.opt_order, use_mask=a.use_mask,
                         opt_env_from=a.opt_env_from, save_path=a.save_path,
                         model_name=a.model_name, spp=a.spp,
                         num_epochs=a.num_epochs, weights_path=a.weights,
                         frame_every=a.frame_every, device=a.device)


if __name__ == "__main__":
    main()
