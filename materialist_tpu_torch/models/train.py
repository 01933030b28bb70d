"""MaterialNet training (counterpart of ``materialist_tpu/models/train.py``),
NCHW.

The losses of the reference's trainer: SiLog depth (λ = 0.5) over the
valid depth range, normal (1 − cos + L1), albedo (L1 plus an optional
perceptual term, LPIPS-alex in the reference: ``models.lpips.lpips_fn``),
L1 roughness and metallic. Partial fine-tuning trains only
``depth_head.scratch.output_conv2`` and the material head's ``scratch``;
the rest is frozen (``requires_grad_(False)``: no update, no weight decay,
as ``optax.set_to_zero`` gives). AdamW with optax's constants (betas
(0.9, 0.999), eps 1e-8), lr 1e-4, weight decay 0.01.

``clip_by_global_norm`` and ``warmup_cosine_decay_schedule`` are written
as optax computes them (float32, no epsilon in the clip), so that the
from-scratch recipe of the trainers, ``chain(clip_by_global_norm(1),
adamw(warmup_cosine))``, follows the JAX package step for step.
``save_checkpoint`` writes the JAX package's flat ``.npz`` layout, which
both packages load.

A step is deterministic, as the JAX package's is on its device: it runs
under ``torch.use_deterministic_algorithms(True)``, so that an op with no
deterministic version raises. On the card cuBLAS then needs
``CUBLAS_WORKSPACE_CONFIG`` (``CUBLAS_WORKSPACE``), which the trainers set
before CUDA starts. New tensors are not filled with NaN
(``fill_uninitialized_memory``): the fills add a third to a step's
launches, and the step repeats bit for bit without them (``chip_smoke.py``
path 8c).

A step is the root span ``train.step`` (``utils/profiling.py``):
``train.forward``, ``train.loss`` (``train.lpips`` inside it),
``train.backward``, ``train.clip`` when it clips and ``train.update``,
with the counters ``train.images`` and ``train.pixels`` (images × H × W)
of its batch.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from materialist_tpu_torch import device as device_mod
from materialist_tpu_torch.models.convert import matnet_to_flax
from materialist_tpu_torch.models.dpt import MaterialNet
from materialist_tpu_torch.utils.profiling import count, span

MIN_DEPTH, MAX_DEPTH = 0.01, 20.0
BETAS, EPS = (0.9, 0.999), 1e-8
# the trainers' reduced encoder (embed 384, depth 6, heads 6; DPT
# features 64): a committable f16 checkpoint
REDUCED = dict(features=64, out_channels=(48, 96, 192, 384),
               layer_idx=(1, 2, 4, 5), embed_dim=384, enc_depth=6,
               num_heads=6)
MAP_KEYS = ("albedo", "roughness", "metallic", "normal", "depth")
# the two workspace settings under which cuBLAS is deterministic
CUBLAS_WORKSPACE = ":4096:8"
CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")
IMAGES, PIXELS = "train.images", "train.pixels"
_STEP = span("train.step")
_FORWARD = span("train.forward")
_LOSS = span("train.loss")
_LPIPS = span("train.lpips")
_BACKWARD = span("train.backward")
_CLIP = span("train.clip")
_UPDATE = span("train.update")


def silog_loss(pred, target, valid, lambd: float = 0.5):
    """Scale-invariant log depth loss over the ``valid`` pixels."""
    eps = 1e-4
    pred = torch.clamp_min(pred, eps)
    target = torch.clamp_min(target, eps)
    diff = (torch.log(target) - torch.log(pred)) * valid
    n = torch.clamp_min(valid.sum(), 1.0)
    m2 = (diff ** 2).sum() / n
    m1 = diff.sum() / n
    return torch.sqrt(torch.clamp_min(m2 - lambd * m1 ** 2, 1e-12))


def matnet_losses(pred, batch, perceptual_fn: Optional[Callable] = None):
    """The loss dict of (B, C, H, W) prediction and target maps."""
    valid = ((batch["depth"] >= MIN_DEPTH)
             & (batch["depth"] <= MAX_DEPTH)).to(torch.float32)
    l_depth = silog_loss(pred["depth"], batch["depth"], valid)
    cos = torch.sum(pred["normal"] * batch["normal"], dim=1)
    l_normal = (1.0 - cos.mean()
                + torch.abs(pred["normal"] - batch["normal"]).mean())
    l_albedo = torch.abs(pred["albedo"] - batch["albedo"]).mean()
    if perceptual_fn is not None:
        with _LPIPS:
            l_albedo = l_albedo + perceptual_fn(pred["albedo"],
                                                batch["albedo"])
    l_rough = torch.abs(pred["roughness"] - batch["roughness"]).mean()
    l_metal = torch.abs(pred["metallic"] - batch["metallic"]).mean()
    total = l_depth + l_normal + l_albedo + l_rough + l_metal
    return {"total": total, "depth": l_depth, "normal": l_normal,
            "albedo": l_albedo, "roughness": l_rough, "metallic": l_metal}


def trainable_names(net: MaterialNet) -> set:
    """The parameters partial fine-tuning trains: the depth head's
    ``scratch.output_conv2`` and the whole ``scratch`` of the material
    head."""
    return {n for n, _ in net.named_parameters()
            if n.startswith(("depth_head.scratch.output_conv2.",
                             "material_head.scratch."))}


def make_optimizer(net: MaterialNet, lr: float = 1e-4,
                   weight_decay: float = 0.01, freeze: bool = True):
    """AdamW over the trainable parameters; with ``freeze`` every other
    parameter gets ``requires_grad_(False)``, else all train."""
    train = trainable_names(net) if freeze else None
    for n, p in net.named_parameters():
        p.requires_grad_(train is None or n in train)
    return torch.optim.AdamW([p for p in net.parameters() if p.requires_grad],
                             lr=lr, betas=BETAS, eps=EPS,
                             weight_decay=weight_decay)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax's schedule of that name, in float32: a linear ramp from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    to ``end_value`` at ``decay_steps`` (which includes the warm-up)."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    t_cos = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac
                         + f32(peak_value))
        c = min(f32(count - warmup_steps), t_cos)
        cos = f32(math.cos(float(f32(math.pi) * c / t_cos)))  # rounded once
        decay = f32(0.5) * (f32(1) + cos)
        return float(f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha)))

    return schedule


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float):
    """optax's ``clip_by_global_norm``: where the global norm of the
    gradients is at least ``max_norm``, every gradient becomes
    ``g / norm * max_norm`` (no epsilon). Returns the norm (0-d tensor);
    the comparison stays on the device."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


@contextlib.contextmanager
def _deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block, raising
    (not warning) where an op has no deterministic version, without the
    NaN fill of new tensors; the caller's settings are restored
    afterwards, on error too."""
    det = torch.utils.deterministic
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        det.fill_uninitialized_memory = was[2]


def _check_cublas(params):
    if (any(p.is_cuda for p in params) and os.environ.get(
            "CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_DETERMINISTIC):
        raise RuntimeError(
            "the training step runs with deterministic algorithms, which "
            "cuBLAS gives only with CUBLAS_WORKSPACE_CONFIG=:4096:8 or "
            ":16:8 in the environment before CUDA starts (found "
            f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')!r})")


def make_train_step(net: MaterialNet, optimizer,
                    perceptual_fn: Optional[Callable] = None,
                    clip_norm: Optional[float] = None,
                    schedule: Optional[Callable] = None):
    """``step(batch)``: forward, losses, backward, optional global-norm
    clip, the learning rate ``schedule(count)`` (count = steps taken so
    far, as optax counts) and one optimizer update, all under
    ``_deterministic_algorithms``. ``batch`` holds (B, C, H, W) tensors on
    the net's device. Returns the detached losses; the clipped gradients
    stay in ``.grad`` until the next step."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    taken = [0]

    def step(batch):
        _check_cublas(params)
        im = batch["im"]
        with _STEP, _deterministic_algorithms():
            count(IMAGES, im.shape[0])
            count(PIXELS, im.shape[0] * im.shape[-2] * im.shape[-1])
            optimizer.zero_grad(set_to_none=True)
            with _FORWARD:
                pred = net(im)
            with _LOSS:
                losses = matnet_losses(pred, batch, perceptual_fn)
            with _BACKWARD:
                losses["total"].backward()
            if clip_norm is not None:
                with _CLIP:
                    clip_by_global_norm(params, clip_norm)
            if schedule is not None:
                for group in optimizer.param_groups:
                    group["lr"] = schedule(taken[0])
            with _UPDATE:
                optimizer.step()
        taken[0] += 1
        return {k: v.detach() for k, v in losses.items()}

    return step


def scratch_step(net: MaterialNet, lr: float, steps: int,
                 warmup_steps: int = 100):
    """The trainers' from-scratch recipe: nothing frozen, gradients
    clipped at a global norm of 1, then AdamW (weight decay 0.01) under
    a warm-up-cosine schedule from 0 to ``lr`` and down to 0.1·lr at
    ``max(steps, warmup_steps + 1)``. Returns ``make_train_step``'s step."""
    sched = warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps, max(steps, warmup_steps + 1), lr * 0.1)
    return make_train_step(net, make_optimizer(net, lr, freeze=False),
                           clip_norm=1.0, schedule=sched)


def map_psnr(pred: dict, target: dict) -> dict:
    """PSNR in dB of each predicted (C, H, W) map against its target,
    peak = the target's range; depth after scaling by the ratio of the
    medians (it is scale-invariant)."""
    out = {}
    for k in MAP_KEYS:
        p, g = pred[k].float(), target[k].float()
        if k == "depth":
            p = p * (torch.quantile(g, 0.5)
                     / torch.clamp_min(torch.quantile(p, 0.5), 1e-6))
        peak = torch.clamp_min(g.max() - g.min(), 1e-6)
        mse = torch.clamp_min(torch.mean((p - g) ** 2), 1e-12)
        out[k] = float(10 * torch.log10(peak * peak / mse))
    return out


def to_nchw(batch: dict, device) -> dict:
    """An NHWC numpy batch (``MGDataset.batches``) as NCHW tensors."""
    return {k: torch.as_tensor(np.ascontiguousarray(v)).permute(0, 3, 1, 2)
            .contiguous().to(device) for k, v in batch.items()}


def train(data_root: str, params: Optional[dict] = None, epochs: int = 1,
          batch_size: int = 2, lr: float = 1e-4,
          save_path: Optional[str] = None, im_hw=(238, 322),
          log_every: int = 10, return_history: bool = False, device=None):
    """Partial fine-tuning of the vit-b MaterialNet on an MG dataset: the
    plain loop of the JAX package (random flips, one shuffle per epoch
    seeded with the epoch). ``params``: a state dict to start from, else
    seeded Flax-default weights. A checkpoint is saved after each epoch
    when ``save_path`` is given. Returns the net (and the per-step total
    losses with ``return_history``)."""
    from materialist_tpu_torch.models.dataset import MGDataset

    dev = device_mod.resolve(device)
    net = MaterialNet(generator=torch.Generator().manual_seed(0))
    if params is not None:
        net.load_state_dict(params)
    net.to(dev)
    step = make_train_step(net, make_optimizer(net, lr))
    ds = MGDataset(data_root, im_height=im_hw[0], im_width=im_hw[1],
                   phase="TRAIN", random_flip=True)
    it, history = 0, []
    for epoch in range(epochs):
        for batch in ds.batches(batch_size, seed=epoch):
            losses = step(to_nchw(batch, dev))
            if return_history:
                history.append(float(losses["total"]))
            if it % log_every == 0:
                print(f"epoch {epoch} it {it} " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in losses.items()),
                    flush=True)
            it += 1
        if save_path:
            save_checkpoint(save_path, net, it)
    return (net, history) if return_history else net


def save_checkpoint(path: str, net: MaterialNet, step: int,
                    config: Optional[dict] = None, half: bool = False):
    """The JAX package's flat ``.npz``: one array per Flax leaf under its
    ``keystr`` (``['pretrained']['block0']['attn']['qkv']['kernel']``),
    ``__step__``, and ``config`` (``net.encoder_config()``) as JSON bytes
    under ``__config__``. ``half`` stores float16 leaves."""
    arrs = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                walk(v, key)
            else:
                arrs[key] = v.astype(np.float16) if half else v

    walk(matnet_to_flax(net.state_dict()), "")
    arrs["__step__"] = np.asarray(step)
    if config is not None:
        arrs["__config__"] = np.frombuffer(json.dumps(config).encode(),
                                           dtype=np.uint8)
    np.savez_compressed(path, **arrs)
