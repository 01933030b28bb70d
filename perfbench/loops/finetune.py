"""Loop ``finetune``: a closed loop of MaterialNet fine-tuning steps on the
program's normal training path: ``cli/train_matnet_device.py::
make_device_step`` over ``models/train.py::make_train_step`` with
``make_optimizer(freeze=True)`` and LPIPS-alex as the perceptual term
(``models/lpips.py::lpips_fn``), the loss read to the host after each
step. Step i draws its batch from fold_in(key(seed), i).

The configuration gives the widths, the crop, the batch, the tuples and
the recipe; the net (``models/dpt.py::MaterialNet``), LPIPS and the
tuples are seeded from ``--seed``. Everything runs in float32: both TF32
flags are off.

Set-up runs the traffic's first steps through the same calls, which warms
every shape and cuDNN's choice of algorithms. The check's steps, those and
one window step drawn from the seed among its first ``window_check_span``,
are recorded: the trained tensors and the optimiser's moments before the
step, its loss, its gradients and the tensors after it. After the window
the plain reference (``perfbench/reference/matnet.py``) works each out
again from the program's state before it.
"""

from __future__ import annotations

import contextlib
import math
import os
import random
import statistics

import torch
import torch.nn.functional as F

from materialist_tpu_torch.models.train import CUBLAS_WORKSPACE
from perfbench.reference import matnet as ref

# the step runs under deterministic algorithms, which cuBLAS gives only
# with a fixed workspace, read when cuBLAS starts: before the first
# product of the run
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)

LABELS = ("step", "readback")


def _smooth(g, n, c, side, dev, lo=0.0, hi=1.0, grid=16):
    """(n, c, side, side) fields in [lo, hi]: seeded uniforms on a coarse
    grid, bilinearly upsampled, plus a fine seeded noise of a twentieth of
    the range."""
    coarse = torch.rand((n, c, grid, grid), generator=g, device=dev)
    fine = torch.rand((n, c, side, side), generator=g, device=dev)
    x = F.interpolate(coarse, size=(side, side), mode="bilinear",
                      align_corners=False)
    return lo + (hi - lo) * torch.clamp(0.95 * x + 0.05 * fine, 0.0, 1.0)


def make_data(conf: dict, seed: int, dev) -> dict:
    """The configuration's tuples, (N, C, H, W) float32 on ``dev`` from
    ``seed``: an image, albedo, roughness and metallic in [0, 1], a unit
    normal facing the camera's half-space, depth in metres in 0.5–10 (all
    inside SiLog's valid 0.01–20)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n, s = conf["tuples"], conf["image"]
    normal = _smooth(g, n, 3, s, dev, -1.0, 1.0)
    normal[:, 2] = normal[:, 2].abs() + 0.2
    normal = normal / torch.linalg.vector_norm(normal, dim=1, keepdim=True)
    return {"im": _smooth(g, n, 3, s, dev),
            "albedo": _smooth(g, n, 3, s, dev),
            "roughness": _smooth(g, n, 1, s, dev),
            "metallic": _smooth(g, n, 1, s, dev),
            "normal": normal,
            "depth": torch.exp(_smooth(g, n, 1, s, dev, math.log(0.5),
                                       math.log(10.0)))}


def seeded_lpips(seed: int):
    """LPIPS-alex (``models/lpips.py::LPIPS``) with seeded weights: the
    trunk's convolutions N(0, 1/fan_in), biases N(0, 0.05²) + 0.02, the
    lin weights N(0, 0.05²) + 0.02 (some negative, which the forward
    clamps at 0)."""
    from materialist_tpu_torch.models.lpips import LPIPS
    g = torch.Generator().manual_seed(seed)
    net = LPIPS()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith("net.") and name.endswith("weight"):
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
            else:
                p.copy_(0.05 * torch.randn(p.shape, generator=g) + 0.02)
    return net


def seeded_net(conf: dict, seed: int):
    """``models/dpt.py::MaterialNet`` at the configuration's widths with
    the Flax-default weights of ``seed``, its depth head's last layer
    scaled by a tenth with its bias at 2 (m). Seeded as they are, the
    head's outputs spread over a few units around a random offset, and
    where they fall at the ReLU's zero SiLog's gradient 1/depth is
    unbounded, so that the last bits of the forward decide it; a trained
    head predicts depths inside the data's range."""
    from materialist_tpu_torch.models.dpt import MaterialNet
    net = MaterialNet(features=conf["features"],
                      out_channels=tuple(conf["out_channels"]),
                      layer_idx=tuple(conf["layer_idx"]),
                      embed_dim=conf["embed_dim"],
                      enc_depth=conf["enc_depth"],
                      num_heads=conf["num_heads"],
                      generator=torch.Generator().manual_seed(seed))
    last = net.depth_head.scratch.output_conv2[2]
    with torch.no_grad():
        last.weight.mul_(0.1)
        last.bias.fill_(2.0)
    return net


class Loop:
    unit_name = "step"

    def __init__(self, conf: dict, traffic: dict, seed: int, dev, log):
        from materialist_tpu_torch import rng
        from materialist_tpu_torch.cli.train_matnet_device import (
            make_device_step)
        from materialist_tpu_torch.models.lpips import lpips_fn
        from materialist_tpu_torch.models.train import (make_optimizer,
                                                        make_train_step)

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.conf, self.traffic, self.seed, self.dev = conf, traffic, seed, dev
        self.rng = rng
        self.data = make_data(conf, seed, dev)
        self.net = seeded_net(conf, seed).to(dev)
        lp = seeded_lpips(seed + 1)
        self.lpips_sd = {k: v.detach().to(dev).clone()
                         for k, v in lp.state_dict().items()}
        self.opt = make_optimizer(self.net, lr=conf["lr"],
                                  weight_decay=conf["weight_decay"],
                                  freeze=True)
        self.trained = {n: p for n, p in self.net.named_parameters()
                        if p.requires_grad}
        self.frozen = {n: p.detach().clone()
                       for n, p in self.net.named_parameters()
                       if not p.requires_grad}
        self.step = make_device_step(
            make_train_step(self.net, self.opt,
                            perceptual_fn=lpips_fn(lp, device=dev)),
            self.data, conf["batch"])
        self.base = rng.key(seed)
        n_train = sum(p.numel() for p in self.trained.values())
        log(f"MaterialNet {sum(p.numel() for p in self.net.parameters())} "
            f"parameters, {n_train} trained in {len(self.trained)} tensors; "
            f"{conf['tuples']} tuples at {conf['image']}², batch "
            f"{conf['batch']}")

        n_check = traffic["check_steps"]
        self.sampled = n_check + random.Random(seed).randrange(
            traffic["window_check_span"])
        self.records = []
        for i in range(n_check):
            self.unit(i)
        self.next = n_check

    def _state(self) -> dict:
        """Copies of the trained tensors, their moments and step count."""
        st = self.opt.state
        return {
            "params": {n: p.detach().clone() for n, p in self.trained.items()},
            "m": {n: (st[p]["exp_avg"].clone() if p in st
                      else torch.zeros_like(p)) for n, p in
                  self.trained.items()},
            "v": {n: (st[p]["exp_avg_sq"].clone() if p in st
                      else torch.zeros_like(p)) for n, p in
                  self.trained.items()},
            "count": max((int(st[p]["step"]) for p in st), default=0)}

    def unit(self, i: int, span=None):
        """Step i; returns its total loss, read on the host."""
        span = span or (lambda label: contextlib.nullcontext())
        checked = i < self.traffic["check_steps"] or i == self.sampled
        before = self._state() if checked else None
        with span("step"):
            losses = self.step(self.rng.fold_in(self.base, i))
        with span("readback"):
            value = float(losses["total"])
        if checked:
            self.records.append(dict(
                i=i, before=before, loss=value,
                grads={n: p.grad.detach().clone()
                       for n, p in self.trained.items()},
                after={n: p.detach().clone()
                       for n, p in self.trained.items()}))
        return value

    def instrument(self, span):
        """Spans inside the program's calls: none for this loop."""
        return contextlib.nullcontext()

    def free(self):
        """Drop the program's state; keep what the check needs."""
        for k in ("net", "opt", "trained", "step"):
            setattr(self, k, None)

    def check(self, limits: dict, log):
        """The plain reference over the recorded steps: (numbers, the
        reference's losses)."""
        nums, ref_losses = {}, []
        for rec in self.records:
            r = reference_step(self.conf, self.seed, self.data, self.frozen,
                               self.lpips_sd, rec)
            got = step_gaps(rec, r)
            ref_losses.append(r["loss"])
            if rec["i"] >= self.traffic["check_steps"]:
                log(f"window step {rec['i']}: "
                    + ", ".join(f"{k} {v!r}" for k, v in got.items()))
            for k, v in got.items():
                nums[k] = max(nums.get(k, 0.0), v)
        return ({k: {"value": v, "limit": limits.get(k)}
                 for k, v in nums.items()}, ref_losses)


def reference_step(conf, seed, data, frozen, lpips_sd, rec, fault=None,
                   tf32=False) -> dict:
    """The reference's step ``rec["i"]`` from the program's tensors and
    moments before it: its loss, its gradients, and AdamW's update of each
    trained tensor from the program's own gradient and moments (the
    update of an element whose gradient sits at rounding level is ±lr
    either way in Adam's first steps, so the update is held to the
    optimiser's arithmetic and the gradient to the reference's)."""
    b = rec["before"]
    P = dict(frozen)
    P.update(b["params"])
    batch = ref.draw_batch(data, seed, rec["i"], conf["batch"])
    terms, grads = ref.loss_and_grads(P, lpips_sd, batch, conf["layer_idx"],
                                      conf["num_heads"], fault, tf32)
    change = {}
    for n, p in b["params"].items():
        new, _, _ = ref.adamw(p, rec["grads"][n], b["m"][n], b["v"][n],
                              b["count"], conf["lr"], conf["weight_decay"],
                              fault)
        change[n] = new - p
    return dict(loss=terms["total"], grads=grads, change=change)


def tensor_gaps(got: dict, want: dict) -> dict:
    """Each tensor's ‖got − want‖ over the larger of its ‖want‖ and the
    median tensor's ‖want‖."""
    norms = {n: float(torch.linalg.vector_norm(w.double()))
             for n, w in want.items()}
    median = statistics.median(norms.values())
    return {n: float(torch.linalg.vector_norm(got[n].double() - w.double()))
            / max(norms[n], median, 1e-30) for n, w in want.items()}


def gaps(loss: float, grads: dict, change: dict, r: dict) -> dict:
    """The numbers a checked step compares against the reference's step
    ``r``: ``loss_gap``, relative; ``grad_gap``, the median over the
    trained tensors of ``tensor_gaps`` of the gradients (a ReLU whose
    input sits at rounding level in the material head's 19x19 level moves
    a few small tensors' gradients by up to ~2e-3 on one step in a few
    dozen, where a lower precision or a wrong loss moves them all);
    ``change_gap``, the worst tensor's gap of the update."""
    return dict(loss_gap=abs(loss - r["loss"]) / max(abs(r["loss"]), 1e-30),
                grad_gap=statistics.median(tensor_gaps(grads,
                                                       r["grads"]).values()),
                change_gap=max(tensor_gaps(change, r["change"]).values()))


def step_gaps(rec: dict, r: dict) -> dict:
    """``gaps`` of the program's recorded step ``rec``."""
    return gaps(rec["loss"], rec["grads"],
                {n: rec["after"][n] - rec["before"]["params"][n]
                 for n in rec["after"]}, r)
