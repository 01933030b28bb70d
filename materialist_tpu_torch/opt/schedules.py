"""Optimizers matching the JAX package's optax setup
(``materialist_tpu/opt/schedules.py``): the reference's gated StepLR
staircase, Adam / AdamW (weight decay 0.01), and the robust rule that a
non-finite gradient skips the whole update (optax.apply_if_finite: the
parameters, the moments and the step count stay as they were).

An optimizer holds only its hyper-parameters: ``state = opt.init(params)``
and ``opt.step(params, grads, state)``, which updates the parameter
tensors in place.
"""

from __future__ import annotations

import torch


def step_lr(base_lr: float, step_size: int = 100, gamma: float = 0.8,
            floor: float = 0.0):
    """StepLR staircase that freezes at the first value at-or-below
    ``floor`` (the reference steps its scheduler only while lr > floor)."""
    k_freeze = None
    if floor > 0:
        k_freeze = 0
        while base_lr * gamma ** k_freeze > floor:
            k_freeze += 1

    def sched(count: int) -> float:
        k = count // step_size
        if k_freeze is not None:
            k = min(k, k_freeze)
        return base_lr * gamma ** k
    return sched


class Adam:
    """Adam (optax.scale_by_adam: b1 0.9, b2 0.999, eps 1e-8) with a
    schedule, decoupled weight decay when ``weight_decay`` > 0 (AdamW),
    and the skip-non-finite-update rule."""

    def __init__(self, lr, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr = lr if callable(lr) else (lambda count, v=lr: v)
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params, grads, state) -> bool:
        """Update ``params`` in place; returns False (and changes nothing)
        when any gradient is not finite."""
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if not bool(finite):
            return False
        lr = self.lr(state["count"])
        count = state["count"] + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            p.sub_(lr * upd)
        state["count"] = count
        return True


def adam_steplr(lr: float, step_size: int = 100, gamma: float = 0.8,
                floor: float = 0.0) -> Adam:
    """Adam + StepLR (envmap phase; direct material phase)."""
    return Adam(step_lr(lr, step_size, gamma, floor))


def adam_plain(lr: float) -> Adam:
    return Adam(lr)


def adamw_steplr(lr: float = 3e-4, step_size: int = 100, gamma: float = 0.8,
                 floor: float = 1.5e-4, weight_decay: float = 0.01) -> Adam:
    """AdamW + floored StepLR (pos_mlp material phase)."""
    return Adam(step_lr(lr, step_size, gamma, floor),
                weight_decay=weight_decay)

