#!/usr/bin/env python3
"""The device trainer's step on the card, timed: ms per step on CUDA
events (the median of steps 21 to 60), device ms per step under
``torch.profiler`` (5 steps), device operations per step and the
heaviest kernels, at PyTorch's default TF32 flags and with TF32 off.

Run on a machine with one NVIDIA GPU, from the root of a checkout:

    python3 scripts/time_train_step.py [--root DIR]

The step is ``chip_smoke.py`` path 8c's: the reduced MaterialNet (seed
0) under the from-scratch recipe, batch 4 at 224×336 drawn from 64
tuples. The tuples are seeded noise made on the card (a step's time does
not depend on their values), so no kernel is built. ``--root`` takes the
package from another checkout (for example a parent commit's
``materialist_tpu_torch/`` unpacked with ``git archive``), so that two
trees are timed in one call, in the order parent, change, change, parent.
``CUBLAS_WORKSPACE_CONFIG`` is ``:4096:8`` for every tree (the value of
``models/train.py``'s ``CUBLAS_WORKSPACE``, written out here because a
tree from before the deterministic step has no such name). Prints the
card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TUPLES, BATCH, STEPS = 64, 4, 60


def seeded_tuples(torch, n):
    """``n`` training tuples at the device trainer's size, seeded noise
    on the card, depth in mm as the trainer keeps it."""
    from materialist_tpu_torch.cli.train_matnet_device import IM_HW
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(c):
        return torch.rand((n, c) + IM_HW, generator=g, device="cuda")
    normal = torch.randn((n, 3) + IM_HW, generator=g, device="cuda")
    return {"im": rand(3), "albedo": rand(3), "roughness": rand(1),
            "metallic": rand(1),
            "normal": normal / normal.norm(dim=1, keepdim=True),
            "depth": 500.0 + 2500.0 * rand(1)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose materialist_tpu_torch is timed")
    a = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path[:0] = [os.path.abspath(a.root), REPO]
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.cli import train_matnet_device as tdev
    from materialist_tpu_torch.models import train as tr
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    defaults = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    data = seeded_tuples(torch, N_TUPLES)
    out = {"package": os.path.dirname(os.path.dirname(tr.__file__)),
           "card": smi, "torch": torch.__version__}
    for label, (mm, conv) in (("default flags", defaults),
                              ("TF32 off", (False, False))):
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv
        net = tdev.reduced_net(0, "cuda")
        step = tdev.make_device_step(tr.scratch_step(net, 3e-4, 300), data,
                                     BATCH)
        losses, ms, key = cs._step_loop(torch, step, STEPS, rng.key(1))
        dev_ms, n_ops, top = cs._top_kernels(
            torch, lambda: step(rng.fold_in(key, 0)), iters=5, n=10)
        out[label] = {"tf32_matmul": mm, "tf32_conv": conv,
                      "ms_per_step": cs._median(ms[20:]),
                      "device_ms_per_step": dev_ms,
                      "device_ops_per_step": n_ops, "top": top,
                      "finite": bool(torch.isfinite(losses).all())}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
