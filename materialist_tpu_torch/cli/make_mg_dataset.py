"""Render a synthetic MG-layout training set with the port's renderer
(counterpart of ``scripts/make_mg_dataset.py``).

Each sample is a random heightfield with a 4×4 palette of albedos,
banded roughness, half-plane metallic and a two-band 16×32 envmap; the
image is ``render/shader.py::render`` with the "exact" march. The layout
is the one ``models.dataset.MGDataset`` reads: ``<out>/scene{s:03d}/
{i}_im.exr`` with ``_albedo``, ``_material`` (roughness, metallic, 0.5
specular), ``_depth`` (mm) and ``_normal`` siblings, all half floats,
and ``<out>/train.txt``. The draws come from the port's threefry keys,
so a seed gives the JAX script's scenes.

Usage: python -m materialist_tpu_torch.cli.make_mg_dataset OUT_DIR
           [--scenes 2] [--per-scene 2] [--height 70] [--width 98]
           [--spp 16] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from materialist_tpu_torch import device as device_mod
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.io import exr
from materialist_tpu_torch.render.scene import Materials, make_gbuffer
from materialist_tpu_torch.render.shader import RenderConfig, render


def _linspace(n: int) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` as XLA's CPU backend evaluates it: s =
    i · f32(1 / (n − 1)), then i · f32(1 / (n − 1)) − (1 − s) with the
    product fused into the subtraction (exact in float64: the product has
    48 bits), the last point 1. Bit for bit at the generators' sizes."""
    i = torch.arange(n - 1, dtype=torch.float32)
    c = torch.tensor(1.0, dtype=torch.float32) / float(n - 1)
    one_minus = 1.0 - i * c
    head = (i.double() * c.double() - one_minus.double()).float()
    return torch.cat([head, torch.ones(1)])


def make_scene(key, h: int, w: int, device=None):
    """Random materials and geometry of one sample: depth (h, w), albedo
    (h, w, 3), roughness and metallic (h, w, 1), envmap (16, 32, 3). The
    draws are made on the host, the maps on ``device``."""
    ks = rng.split(key, 8)
    yy, xx = torch.meshgrid(_linspace(h).to(device), _linspace(w).to(device),
                            indexing="ij")

    def draw(k, shape, lo=0.0, hi=1.0):
        return rng.uniform(k, shape, minval=lo, maxval=hi).to(device)

    fx, fy = draw(ks[0], (2,), 1.0, 4.0)
    depth = 2.0 + 0.4 * torch.sin(fx * 3 * xx) * torch.cos(fy * 2 * yy) \
        + 0.2 * draw(ks[1], ())
    pal = draw(ks[2], (4, 4, 3), 0.05, 0.95)
    gi = torch.clamp(((yy + 1) * 2).to(torch.int32), 0, 3)
    gj = torch.clamp(((xx + 1) * 2).to(torch.int32), 0, 3)
    albedo = pal[gi, gj]
    rough = torch.clamp(0.3 + 0.5 * torch.sin(fy * 4 * xx + fx)[..., None],
                        0.07, 1.0)
    metal = (draw(ks[3], ()) < 0.5).to(torch.float32) * torch.clamp(
        0.8 * (xx > 0).to(torch.float32)[..., None], 0, 1)
    env_top = draw(ks[4], (3,), 0.8, 2.5)
    env_bot = draw(ks[5], (3,), 0.05, 0.4)
    env = torch.cat([env_top.expand(8, 32, 3), env_bot.expand(8, 32, 3)])
    return depth, albedo, rough, metal, env


def render_scene(key, h: int, w: int, cfg: RenderConfig, device):
    """One sample: ``make_scene`` on a split of ``key``, its G-buffer and
    the rendered image (no gradient). Returns (image, depth, albedo,
    roughness, metallic, geometric normal), all on ``device``."""
    k1, k2 = key
    depth, albedo, rough, metal, env = make_scene(k1, h, w, device)
    gbuf = make_gbuffer(depth, Camera(h, w), flip_depth=False)
    mats = Materials(albedo, rough, metal, gbuf.normal_geo)
    with torch.no_grad():
        img = render(k2, cfg, Camera(h, w), gbuf, mats, env)
    return img, depth, albedo, rough, metal, gbuf.normal_geo


def generate(out: str, scenes: int, per_scene: int, h: int, w: int,
             spp: int, seed: int = 0, device=None) -> None:
    """Write ``scenes`` × ``per_scene`` samples under ``out``, rendered on
    ``device`` (the card unless the CPU is asked for)."""
    dev = device_mod.resolve(device)
    cfg = RenderConfig(spp=spp, chunk=min(8, spp), march_steps=8,
                       shadow_steps=8, march_impl="exact",
                       march_vectorized=True)
    names = []
    key = rng.key(seed)
    for s in range(scenes):
        names.append(f"scene{s:03d}")
        sdir = os.path.join(out, names[-1])
        os.makedirs(sdir, exist_ok=True)
        for i in range(per_scene):
            key, k1, k2 = rng.split(key, 3)
            img, depth, albedo, rough, metal, normal = (
                t.cpu().numpy() for t in render_scene((k1, k2), h, w, cfg,
                                                      dev))
            pre = os.path.join(sdir, f"{i}")
            exr.write(pre + "_im.exr", img, half=True)
            exr.write(pre + "_albedo.exr", albedo, half=True)
            matpack = np.concatenate(
                [rough, metal, np.full((h, w, 1), 0.5, np.float32)], axis=-1)
            exr.write(pre + "_material.exr", matpack, half=True)
            exr.write(pre + "_depth.exr", depth[..., None] * 1e3, half=True)
            exr.write(pre + "_normal.exr", normal, half=True)
    with open(os.path.join(out, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    print(f"wrote {scenes * per_scene} samples to {out}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--per-scene", type=int, default=2)
    ap.add_argument("--height", type=int, default=70)
    ap.add_argument("--width", type=int, default=98)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    generate(a.out, a.scenes, a.per_scene, a.height, a.width, a.spp,
             a.seed, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
