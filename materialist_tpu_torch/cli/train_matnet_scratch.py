"""Train the reduced MaterialNet from scratch on an MG dataset on disk
(counterpart of ``scripts/train_matnet_scratch.py``).

The data is rendered by ``cli/make_mg_dataset.py::generate`` at 238×322
(multiples of 14) unless ``OUT_DIR/mg_data`` already holds it, read back
by ``models.dataset.MGDataset`` with random flips, and fed to the
from-scratch recipe (``models.train.scratch_step``: nothing frozen, clip
at 1, AdamW under warm-up-cosine). The f16 checkpoint stores the
encoder's config, so ``cli/inverse.py --weights`` rebuilds the net; the
held-out map PSNR comes from fresh scenes (seed + 7777).

Usage: python -m materialist_tpu_torch.cli.train_matnet_scratch OUT_DIR
           [--scenes 150] [--per-scene 3] [--steps 3000] [--batch 4]
           [--spp 32] [--lr 3e-4] [--time-budget 3600] [--seed 0]
           [--skip-data] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from materialist_tpu_torch import device as device_mod
from materialist_tpu_torch.cli.make_mg_dataset import generate
from materialist_tpu_torch.cli.train_matnet_device import (heldout_psnr,
                                                           reduced_net)
from materialist_tpu_torch.models.dataset import MGDataset
from materialist_tpu_torch.models.train import (save_checkpoint,
                                                scratch_step, to_nchw)

IM_HW = (238, 322)   # the multiple-of-14 nearest the reference's 240×320


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--scenes", type=int, default=150)
    ap.add_argument("--per-scene", type=int, default=3)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--time-budget", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-data", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = device_mod.resolve(a.device)

    data_dir = os.path.join(a.out, "mg_data")
    if not a.skip_data and not os.path.exists(
            os.path.join(data_dir, "train.txt")):
        print(f"[scratch] rendering {a.scenes}×{a.per_scene} MG tuples at "
              f"{IM_HW} ×{a.spp}spp", flush=True)
        t0 = time.time()
        generate(data_dir, a.scenes, a.per_scene, IM_HW[0], IM_HW[1], a.spp,
                 seed=a.seed, device=dev)
        print(f"[scratch] dataset rendered in {time.time() - t0:.0f}s",
              flush=True)

    net = reduced_net(a.seed, dev)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"[scratch] reduced MaterialNet: {n_params / 1e6:.1f}M params",
          flush=True)
    step = scratch_step(net, a.lr, a.steps)
    ds = MGDataset(data_dir, im_height=IM_HW[0], im_width=IM_HW[1],
                   phase="TRAIN", random_flip=True)
    deadline = time.time() + a.time_budget if a.time_budget else None

    it, epoch, hist, stop = 0, 0, [], False
    t0 = time.time()
    while not stop:
        for batch in ds.batches(a.batch, seed=epoch):
            losses = step(to_nchw(batch, dev))
            if it % 25 == 0:
                vals = {k: float(v) for k, v in losses.items()}
                hist.append({"it": it, **vals})
                print(f"[scratch] it {it} " + " ".join(
                    f"{k}={v:.4f}" for k, v in vals.items()), flush=True)
            it += 1
            if it >= a.steps or (deadline and time.time() > deadline):
                stop = True
                break
        epoch += 1

    ckpt = os.path.join(a.out, "matnet_scratch.npz")
    save_checkpoint(ckpt, net, it, config=net.encoder_config(), half=True)
    sz = os.path.getsize(ckpt) / 1e6
    print(f"[scratch] checkpoint {ckpt} ({sz:.1f} MB) after {it} steps, "
          f"{(time.time() - t0) / 60:.1f} min", flush=True)

    eval_dir = os.path.join(a.out, "mg_eval")
    if not os.path.exists(os.path.join(eval_dir, "train.txt")):
        generate(eval_dir, 4, 2, IM_HW[0], IM_HW[1], a.spp,
                 seed=a.seed + 7777, device=dev)
    ev = MGDataset(eval_dir, im_height=IM_HW[0], im_width=IM_HW[1],
                   phase="TRAIN", random_flip=False)
    samples = [to_nchw({k: v[None] for k, v in ev[i].items()}, dev)
               for i in range(len(ev))]
    summary = heldout_psnr(net, {k: torch.cat([s[k] for s in samples])
                                 for k in samples[0]})
    print(f"[scratch] held-out map PSNR (dB): {summary}", flush=True)
    with open(os.path.join(a.out, "train_log.json"), "w") as f:
        json.dump({"steps": it, "params_M": n_params / 1e6,
                   "history": hist, "heldout_psnr_db": summary,
                   "checkpoint_mb": sz}, f, indent=1)
    print(json.dumps({"steps": it, "heldout_psnr_db": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
