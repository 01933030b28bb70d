"""Plain-PyTorch reference of MaterialNet's fine-tuning step, float32, for
the check of ``matnet518.finetune``. It imports nothing of the program.

It follows upstream Materialist (github.com/lez-s/Materialist, arXiv
2501.03717): ``Material_net/dpt.py:175-217`` (a DINOv2 ViT encoder, four of
its layers into two DPT heads, depth and material), ``dinov2.py:353-415``
(pre-norm blocks, LayerScale on both residual paths, a GELU MLP, no
registers) and ``train_matnet.py:52-194`` (partial fine-tuning of
``depth_head.scratch.output_conv2`` and ``material_head.scratch``; SiLog
depth, normal 1 − cos + L1, albedo L1 + LPIPS-alex, L1 roughness and
metallic; AdamW). Every layer is written out on a flat dict of tensors
under the upstream state dict's names: attention as softmax(QKᵀ/√d)·V,
the heads through ``F.conv2d`` and ``F.conv_transpose2d``, the
align-corners bilinear by its two taps, LPIPS-alex (the ``lpips``
package's network), and AdamW.

Both TF32 flags are off: a float32 product may otherwise run in TF32 on
the card. ``tf32=True`` turns them on, for the control.

Departures from upstream, each shared with the program:

- only the pos-embed's native grid (37×37 patches at 518²): no bicubic
  interpolation of it (``forward`` raises on another size);
- SiLog clamps the prediction and the target at 1e-4 before the log and
  the root's argument at 1e-12 (a ReLU prediction of 0 would give log 0);
- LPIPS divides each feature by its channel norm clamped at 1e-10, where
  ``lpips`` adds 1e-10 to the norm: the two differ by under 1e-10
  relative wherever the norm exceeds 1e-10, and an all-zero feature gets a
  zero gradient, not 0/0;
- the depth head's output passes a second ReLU in the model's forward, as
  upstream's does: it changes nothing.

The whole batch runs at once: at 518² and batch 16 it fits the card (the
frozen encoder keeps no graph), so no blocks of images are needed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import rng

PATCH = 14
NATIVE = 37                 # the pos-embed's grid: 518 / 14
MIN_DEPTH, MAX_DEPTH = 0.01, 20.0
BETAS, EPS = (0.9, 0.999), 1e-8
# the parameters the partial fine-tune trains (train_matnet.py:163-194)
TRAINABLE = ("depth_head.scratch.output_conv2.", "material_head.scratch.")
# LPIPS-alex: the scaling layer, then AlexNet's convolutions (torchvision
# index, stride, padding), a max-pool before the second and third
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_ALEX = ((0, 4, 2), (3, 1, 2), (6, 1, 1), (8, 1, 1), (10, 1, 1))
FAULTS = ("lpips", "half", "wd")


class _TF32:
    """Both TF32 flags set to ``on`` for the block, restored after."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.was = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.was
        return False


def trainable(name: str) -> bool:
    return name.startswith(TRAINABLE)


def _dense(P, name, x):
    return x @ P[f"{name}.weight"].t() + P[f"{name}.bias"]


def _conv(P, name, x, stride=1, padding=0):
    return F.conv2d(x, P[f"{name}.weight"], P.get(f"{name}.bias"),
                    stride=stride, padding=padding)


def _layer_norm(P, name, x):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                        P[f"{name}.bias"], eps=1e-6)


def encoder(P, x, layer_idx, num_heads):
    """The patch tokens (B, N, C) of each layer in ``layer_idx``, after
    the final LayerNorm."""
    x = _conv(P, "pretrained.patch_embed.proj", x, stride=PATCH)
    b, c, gh, gw = x.shape
    if (gh, gw) != (NATIVE, NATIVE):
        raise ValueError(f"the reference takes only the native {NATIVE}x"
                         f"{NATIVE} patch grid, not {gh}x{gw}")
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([P["pretrained.cls_token"].expand(b, -1, -1), x], dim=1)
    x = x + P["pretrained.pos_embed"]
    n, hd = x.shape[1], c // num_heads
    outs = []
    depth = 1 + max(int(k.split(".")[2]) for k in P
                    if k.startswith("pretrained.blocks."))
    for i in range(depth):
        pre = f"pretrained.blocks.{i}"
        h = _layer_norm(P, f"{pre}.norm1", x)
        q, k, v = (_dense(P, f"{pre}.attn.qkv", h)
                   .reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        a = (att @ v).transpose(1, 2).reshape(b, n, c)
        x = x + P[f"{pre}.ls1.gamma"] * _dense(P, f"{pre}.attn.proj", a)
        h = _layer_norm(P, f"{pre}.norm2", x)
        h = _dense(P, f"{pre}.mlp.fc2",
                   F.gelu(_dense(P, f"{pre}.mlp.fc1", h)))
        x = x + P[f"{pre}.ls2.gamma"] * h
        if i in layer_idx:
            outs.append(_layer_norm(P, "pretrained.norm", x)[:, 1:])
    return outs


def _taps(n_out: int, n_in: int, device):
    """Align-corners sample positions on one axis: the float32 position
    (n_in − 1)/(n_out − 1)·i, its floor and the next index (the last index
    alone at the end), and the weight of the next."""
    scale = (torch.tensor(float(n_in - 1), dtype=torch.float32)
             / torch.tensor(float(n_out - 1), dtype=torch.float32)
             if n_out > 1 else torch.tensor(0.0))
    src = scale * torch.arange(n_out, dtype=torch.float32)
    i0 = src.to(torch.int64)
    lam = src - i0.to(torch.float32)
    i1 = torch.clamp_max(i0 + 1, n_in - 1)
    return i0.to(device), i1.to(device), lam.to(device)


def bilinear(x, size):
    """Align-corners bilinear of (B, C, H, W) to ``size``: rows, then
    columns, each from its two taps."""
    r0, r1, ly = _taps(size[0], x.shape[-2], x.device)
    c0, c1, lx = _taps(size[1], x.shape[-1], x.device)
    ly = ly[:, None]
    x = x.index_select(-2, r0) * (1 - ly) + x.index_select(-2, r1) * ly
    return x.index_select(-1, c0) * (1 - lx) + x.index_select(-1, c1) * lx


def _rcu(P, name, x):
    y = _conv(P, f"{name}.conv1", F.relu(x), padding=1)
    return x + _conv(P, f"{name}.conv2", F.relu(y), padding=1)


def _fusion(P, name, x, res=None, size=None):
    if res is not None:
        x = x + _rcu(P, f"{name}.resConfUnit1", res)
    x = _rcu(P, f"{name}.resConfUnit2", x)
    if size is None:
        size = (x.shape[-2] * 2, x.shape[-1] * 2)
    return _conv(P, f"{name}.out_conv", bilinear(x, size))


def head(P, name, levels, ph, pw):
    """A DPT head: (B, 1, H, W) depth or (B, 8, H, W) material."""
    rn = []
    for i, tokens in enumerate(levels):
        b, _, c = tokens.shape
        x = tokens.transpose(1, 2).reshape(b, c, ph, pw)
        x = _conv(P, f"{name}.projects.{i}", x)
        rz = f"{name}.resize_layers.{i}"
        if i in (0, 1):
            x = F.conv_transpose2d(x, P[f"{rz}.weight"], P[f"{rz}.bias"],
                                   stride=4 if i == 0 else 2)
        elif i == 3:
            x = _conv(P, rz, x, stride=2, padding=1)
        rn.append(_conv(P, f"{name}.scratch.layer{i + 1}_rn", x, padding=1))
    s = f"{name}.scratch"
    path = _fusion(P, f"{s}.refinenet4", rn[3], size=rn[2].shape[-2:])
    path = _fusion(P, f"{s}.refinenet3", path, rn[2], size=rn[1].shape[-2:])
    path = _fusion(P, f"{s}.refinenet2", path, rn[1], size=rn[0].shape[-2:])
    path = _fusion(P, f"{s}.refinenet1", path, rn[0])
    x = _conv(P, f"{s}.output_conv1", path, padding=1)
    x = bilinear(x, (ph * PATCH, pw * PATCH))
    x = _conv(P, f"{s}.output_conv2.0", x, padding=1)
    x = _conv(P, f"{s}.output_conv2.2", F.relu(x))
    if name == "depth_head":
        return F.relu(x)
    normal = torch.tanh(x[:, 5:8])
    normal = normal / torch.clamp_min(
        torch.linalg.vector_norm(normal, dim=1, keepdim=True), 1e-6)
    return torch.cat([F.relu(x[:, :5]), normal], dim=1)


def forward(P, x, layer_idx, num_heads):
    """The five maps of images x (B, 3, 518, 518)."""
    ph, pw = x.shape[-2] // PATCH, x.shape[-1] // PATCH
    with torch.no_grad():       # the encoder is frozen
        levels = encoder(P, x, layer_idx, num_heads)
    depth = F.relu(head(P, "depth_head", levels, ph, pw))
    m = head(P, "material_head", levels, ph, pw)
    return {"depth": depth, "albedo": m[:, 0:3], "roughness": m[:, 3:4],
            "metallic": m[:, 4:5], "normal": m[:, 5:8]}


def lpips(L, x, y):
    """LPIPS-alex (B,) of two (B, 3, H, W) batches in [0, 1]; ``L``: the
    ``lpips`` package's state dict (``net.slice{k}.{idx}``, ``lin{i}``)."""
    shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    total = 0.0
    fx, fy = ((2.0 * t - 1.0 - shift) / scale for t in (x, y))
    for k, (idx, stride, pad) in enumerate(_ALEX):
        if k in (1, 2):
            fx, fy = F.max_pool2d(fx, 3, 2), F.max_pool2d(fy, 3, 2)
        name = f"net.slice{k + 1}.{idx}"
        fx = F.relu(_conv(L, name, fx, stride, pad))
        fy = F.relu(_conv(L, name, fy, stride, pad))
        a, b = (f / torch.clamp_min(torch.linalg.vector_norm(
            f, dim=1, keepdim=True), 1e-10) for f in (fx, fy))
        w = torch.clamp_min(L[f"lin{k}.model.1.weight"], 0.0)
        total = total + torch.sum((a - b) ** 2 * w, dim=1).mean(dim=(1, 2))
    return total


def losses(pred, batch, L, fault=None):
    """The five loss terms and their sum. ``fault="lpips"`` leaves the
    perceptual term out, ``fault="half"`` the second half of the batch."""
    if fault == "half":
        h = pred["depth"].shape[0] // 2
        pred = {k: v[:h] for k, v in pred.items()}
        batch = {k: v[:h] for k, v in batch.items()}
    valid = ((batch["depth"] >= MIN_DEPTH)
             & (batch["depth"] <= MAX_DEPTH)).to(torch.float32)
    diff = (torch.log(torch.clamp_min(batch["depth"], 1e-4))
            - torch.log(torch.clamp_min(pred["depth"], 1e-4))) * valid
    n = torch.clamp_min(valid.sum(), 1.0)
    l_depth = torch.sqrt(torch.clamp_min(
        (diff ** 2).sum() / n - 0.5 * (diff.sum() / n) ** 2, 1e-12))
    cos = torch.sum(pred["normal"] * batch["normal"], dim=1)
    l_normal = (1.0 - cos.mean()
                + torch.abs(pred["normal"] - batch["normal"]).mean())
    l_albedo = torch.abs(pred["albedo"] - batch["albedo"]).mean()
    if fault != "lpips":
        l_albedo = l_albedo + lpips(L, pred["albedo"], batch["albedo"]).mean()
    l_rough = torch.abs(pred["roughness"] - batch["roughness"]).mean()
    l_metal = torch.abs(pred["metallic"] - batch["metallic"]).mean()
    total = l_depth + l_normal + l_albedo + l_rough + l_metal
    return {"total": total, "depth": l_depth, "normal": l_normal,
            "albedo": l_albedo, "roughness": l_rough, "metallic": l_metal}


def loss_and_grads(P, L, batch, layer_idx, num_heads, fault=None,
                   tf32=False):
    """One step's loss terms (floats) and the gradient of the total with
    respect to each trainable tensor of ``P``."""
    params = {k: (v.detach().clone().requires_grad_(True) if trainable(k)
                  else v.detach()) for k, v in P.items()}
    with _TF32(tf32):
        out = losses(forward(params, batch["im"], layer_idx, num_heads),
                     batch, L, fault)
        names = [k for k in params if trainable(k)]
        grads = torch.autograd.grad(out["total"],
                                    [params[k] for k in names])
    return ({k: float(v.detach()) for k, v in out.items()},
            dict(zip(names, grads)))


def adamw(p, g, m, v, step: int, lr: float, weight_decay: float,
          fault=None):
    """AdamW's update of tensor ``p`` (torch's order of operations: the
    decay, then m and v, then the bias-corrected step), from its gradient
    ``g`` and its moments ``m``, ``v`` after ``step`` earlier steps.
    Returns the new (p, m, v). ``fault="wd"`` skips the decay."""
    b1, b2 = BETAS
    t = step + 1
    if fault != "wd":
        p = p * (1.0 - lr * weight_decay)
    m = m + (g - m) * (1.0 - b1)
    v = v * b2 + g * g * (1.0 - b2)
    denom = v.sqrt() / math.sqrt(1.0 - b2 ** t) + EPS
    return p - (lr / (1.0 - b1 ** t)) * (m / denom), m, v


def randint(k, shape, maxval: int, device=None):
    """``jax.random.randint(k, shape, 0, maxval)``: two 32-bit draws of
    ``split(k)`` as (hi mod span)·(2³² mod span) + (lo mod span), mod
    span, in uint32 arithmetic."""
    k1, k2 = rng.split(k)
    hi = rng.bits(k1, tuple(shape), device)
    lo = rng.bits(k2, tuple(shape), device)
    span = maxval
    mult = ((2 ** 16 % span) ** 2 & 0xFFFFFFFF) % span
    a = hi % span
    prod = ((a & 0xFFFF) * mult
            + ((((a >> 16) * mult) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return (((prod + lo % span) & 0xFFFFFFFF) % span).to(torch.int64)


def draw_batch(data: dict, seed: int, i: int, batch: int) -> dict:
    """Step i's batch: ``batch`` tuple indices (with replacement) and
    flips (p 0.5) from fold_in(key(seed), i), each flipped tuple mirrored
    left to right with its normal's x negated."""
    dev = data["im"].device
    k_idx, k_flip = rng.split(rng.fold_in(rng.key(seed), i))
    idx = randint(k_idx, (batch,), data["im"].shape[0]).to(dev)
    flip = (rng.uniform(k_flip, (batch,)) < 0.5).to(dev)
    out = {}
    for k, v in data.items():
        v = v[idx]
        out[k] = torch.where(flip.view(-1, 1, 1, 1), v.flip(-1), v)
    sign = torch.where(flip, -1.0, 1.0)
    out["normal"] = torch.cat([out["normal"][:, :1] * sign.view(-1, 1, 1, 1),
                               out["normal"][:, 1:]], dim=1)
    return out
