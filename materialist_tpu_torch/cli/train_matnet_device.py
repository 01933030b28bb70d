"""Train the reduced MaterialNet with its training data rendered on the
card (counterpart of ``scripts/train_matnet_device.py``).

``render_dataset`` renders the tuples with the port's renderer (the
default ``RenderConfig``: "fused" march, NEE, Disney; the scenes of
``cli/make_mg_dataset.py::make_scene``) straight into one stacked dict of
(N, C, H, W) tensors on the card. Each step draws its batch indices and
flips with the port's threefry keys on the card (``rng.randint``,
``rng.bernoulli``), mirrors the flipped tuples and negates their
normal-x, and takes one step of the from-scratch recipe
(``models.train.scratch_step``). Only the losses at the log points and
the f16 checkpoint leave the card. Each step is deterministic
(``models.train.make_train_step``), so a run repeats bit for bit from
its seed. As in the JAX script, depth is kept in mm, outside the loss's
valid range of 0.01–20: its term stays at the floor 1e-6 and the depth
head does not train.

Usage: python -m materialist_tpu_torch.cli.train_matnet_device OUT_DIR
           [--tuples 256] [--steps 3000] [--batch 4] [--spp 32]
           [--lr 3e-4] [--time-budget 3600] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from materialist_tpu_torch import device as device_mod
from materialist_tpu_torch import rng
from materialist_tpu_torch.cli.make_mg_dataset import render_scene
from materialist_tpu_torch.models.dpt import MaterialNet
from materialist_tpu_torch.models.train import (CUBLAS_WORKSPACE, REDUCED,
                                                map_psnr, save_checkpoint,
                                                scratch_step)
from materialist_tpu_torch.render.shader import RenderConfig
from materialist_tpu_torch.utils.profiling import span

IM_HW = (224, 336)   # multiples of 14 (ViT patch) and 16 (march mip)
DATA_KEYS = ("im", "albedo", "roughness", "metallic", "normal", "depth")
_BATCH = span("train.batch")


def render_dataset(n_tuples: int, spp: int, seed: int, device=None) -> dict:
    """Render ``n_tuples`` samples on ``device``: (N, C, H, W) float32
    tensors under ``DATA_KEYS`` (depth in mm)."""
    dev = device_mod.resolve(device)
    h, w = IM_HW
    cfg = RenderConfig(spp=spp, chunk=min(8, spp))
    key = rng.key(seed)
    outs = {k: [] for k in DATA_KEYS}
    t0 = time.time()
    for i in range(n_tuples):
        key, k1, k2 = rng.split(key, 3)
        img, depth, albedo, rough, metal, normal = render_scene(
            (k1, k2), h, w, cfg, dev)
        for k, v in zip(DATA_KEYS, (img, albedo, rough, metal, normal,
                                    depth[..., None] * 1000.0)):
            outs[k].append(v.permute(2, 0, 1))
        if (i + 1) % 32 == 0:
            print(f"[device-train] rendered {i + 1}/{n_tuples} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    data = {k: torch.stack(v) for k, v in outs.items()}
    mb = sum(v.numel() * v.element_size() for v in data.values()) / 1e6
    print(f"[device-train] dataset on {dev}: {mb:.0f} MB in "
          f"{time.time() - t0:.0f}s", flush=True)
    return data


def reduced_net(seed: int, device) -> MaterialNet:
    """The reduced MaterialNet with seeded Flax-default weights."""
    return MaterialNet(**REDUCED, generator=torch.Generator().manual_seed(
        seed)).to(device)


def make_device_step(train_step, data: dict, batch: int):
    """``step(key)``: draw ``batch`` tuple indices and flips from ``key``
    on the data's device, mirror the flipped tuples (normal-x negated) and
    run ``train_step`` on them. The draw, the gather and the flips are the
    root span ``train.batch``, closed before the step opens its own."""
    dev = data["im"].device
    n = data["im"].shape[0]
    neg_x = torch.tensor([-1.0, 1.0, 1.0], device=dev).view(1, 3, 1, 1)

    def step(key):
        with _BATCH:
            k_idx, k_flip = rng.split(key)
            idx = rng.randint(k_idx, (batch,), 0, n, device=dev)
            flip = rng.bernoulli(k_flip, 0.5, (batch,), device=dev)
            flip = flip.view(batch, 1, 1, 1)
            b = {}
            for k, v in data.items():
                v = v.index_select(0, idx)
                b[k] = torch.where(flip, v.flip(-1), v)
            b["normal"] = b["normal"] * torch.where(flip, neg_x, 1.0)
        return train_step(b)

    return step


@torch.no_grad()
def heldout_psnr(net: MaterialNet, data: dict) -> dict:
    """Mean map PSNR (dB) of ``net`` over the tuples of ``data``."""
    vals = []
    for i in range(data["im"].shape[0]):
        pred = net(data["im"][i:i + 1])
        vals.append(map_psnr({k: v[0] for k, v in pred.items()},
                             {k: v[i] for k, v in data.items()}))
    return {k: round(sum(v[k] for v in vals) / len(vals), 2)
            for k in vals[0]}


def main(argv=None):
    # the deterministic training step needs it before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--tuples", type=int, default=256)
    ap.add_argument("--eval-tuples", type=int, default=8)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--time-budget", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = device_mod.resolve(a.device)
    os.makedirs(a.out, exist_ok=True)

    data = render_dataset(a.tuples, a.spp, a.seed, dev)
    net = reduced_net(a.seed, dev)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"[device-train] reduced MaterialNet: {n_params / 1e6:.1f}M "
          "params", flush=True)
    step = make_device_step(scratch_step(net, a.lr, a.steps), data, a.batch)

    deadline = time.time() + a.time_budget if a.time_budget else None
    hist = []
    t0 = time.time()
    key = rng.key(a.seed + 1)
    it = 0
    for it in range(a.steps):
        key, k = rng.split(key)
        losses = step(k)
        if it % 50 == 0 or it == a.steps - 1:
            vals = {kk: float(v) for kk, v in losses.items()}
            hist.append({"it": it, **vals})
            print(f"[device-train] it {it} " + " ".join(
                f"{kk}={v:.4f}" for kk, v in vals.items()), flush=True)
        if deadline and time.time() > deadline:
            print(f"[device-train] time budget hit at it {it}", flush=True)
            break
    train_min = (time.time() - t0) / 60
    print(f"[device-train] trained {it + 1} steps in {train_min:.1f} min",
          flush=True)

    ckpt = os.path.join(a.out, "matnet_scratch.npz")
    save_checkpoint(ckpt, net, it + 1, config=net.encoder_config(),
                    half=True)
    sz = os.path.getsize(ckpt) / 1e6
    print(f"[device-train] checkpoint {ckpt} ({sz:.1f} MB)", flush=True)

    summary = heldout_psnr(net, render_dataset(a.eval_tuples, a.spp,
                                               a.seed + 7777, dev))
    print(f"[device-train] held-out map PSNR (dB): {summary}", flush=True)
    with open(os.path.join(a.out, "train_log.json"), "w") as f:
        json.dump({"steps": it + 1, "params_M": n_params / 1e6,
                   "train_min": round(train_min, 1), "tuples": a.tuples,
                   "spp": a.spp, "history": hist,
                   "heldout_psnr_db": summary,
                   "checkpoint_mb": round(sz, 1)}, f, indent=1)
    print(json.dumps({"steps": it + 1, "heldout_psnr_db": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
