"""The plain reference of one inverse step: the plan's groups and chunks,
the trace of every chunk, the image, the loss, the adjoint (each chunk's
shade again under autograd, back-propagated with the image's cotangent,
as the program's step does to keep one chunk's graph alive), and the Adam
update. Also the plan and the optimizer, each a frozen transcription.

``run_steps`` drives ``n`` steps from a starting state and reports what
the comparison reads: each step's loss, the first gradient of each leaf,
every step's gradient norms, and each leaf's change over the ``n`` steps.
``one_step`` takes one step from a given state.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from perfbench.reference import rng
from perfbench.reference import tracer as T

# the plan's byte estimates per path vertex and per primary ray
REPLAY_REC_BYTES = 66.0
LIGHT_REC_BYTES = 42.0
SHADE_VJP_BYTES = 192.0
TRACE_CHUNK_BYTES = 320.0
HEADROOM = 0.50


def plan(res: int, spp: int, hbm_bytes: int, max_chunk: int, bounces: int,
         caps: tuple):
    """(groups, chunk, replay_blob) of a step at res² × spp on a card of
    ``hbm_bytes``: the fastest setting whose records and one group's
    adjoint working set fit half the memory."""
    vert_frac = ((1.0 + sum(caps[min(i, len(caps) - 1)]
                            for i in range(bounces - 1))) / bounces
                 if caps else 1.0)
    budget = hbm_bytes * HEADROOM
    n_px = res * res
    verts = float(n_px) * spp * bounces * vert_frac
    groups = 1
    while (verts / groups) * SHADE_VJP_BYTES > 0.5 * budget and groups < spp:
        groups *= 2
    chunk = min(max_chunk, max(spp // groups, 1))
    while float(n_px) * chunk * TRACE_CHUNK_BYTES > 0.5 * budget \
            and chunk > 1:
        chunk //= 2
    for rec_bytes, replay in ((REPLAY_REC_BYTES, True),
                              (LIGHT_REC_BYTES, False)):
        for g in (groups, 2 * groups, 4 * groups):
            if g > spp:
                break
            if verts * rec_bytes + (verts / g) * SHADE_VJP_BYTES <= budget:
                return g, min(chunk, max(spp // g, 1)), replay
    return groups, chunk, False


def step_lr(base_lr: float, step_size: int = 100, gamma: float = 0.8,
            floor: float = 0.0):
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
    """Adam (b1 0.9, b2 0.999, eps 1e-8) with a schedule, decoupled weight
    decay when given (AdamW), and no update at all when a gradient is not
    finite."""

    def __init__(self, lr: Callable, weight_decay: float = 0.0):
        self.lr = lr
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8

    def init(self, params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params, grads, state) -> bool:
        if not all(bool(torch.isfinite(g).all()) for g in grads):
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


class Phase(NamedTuple):
    """A phase's parameterisation: ``params`` (name → leaf), ``maps_of
    (params) -> (albedo, rough, metal, normal, env)``, ``loss_of(maps,
    img) -> loss`` and the optimizer."""
    params: dict
    maps_of: Callable
    loss_of: Callable
    opt: Adam


def trace(phase: Phase, key, cfg: T.Cfg, cam, geo, tab, n_groups):
    """(chunk keys, records) of a step's trace."""
    keys = T.chunk_keys(key, cfg, n_groups)
    with torch.no_grad():
        maps = phase.maps_of(phase.params)
        table = T.pack(*maps[:4])
        return keys, [T.trace_chunk(k, cfg, cam, geo, tab, table, maps[4])
                      for k in keys]


def _step(phase: Phase, state, traced, cfg: T.Cfg, cam, geo, dtype, fault):
    plist = list(phase.params.values())
    keys, recs = traced
    use = list(range(len(keys)))
    if fault == "half":
        use = use[:max(len(use) // 2, 1)]
    for p in plist:
        p.grad = None
    fields = list(phase.maps_of(phase.params))
    leaves = [f.detach().requires_grad_(f.requires_grad) for f in fields]

    def shade(c):
        img = T.shade_chunk(keys[c], recs[c], cfg, cam, geo,
                            T.pack(*leaves[:4]), leaves[4], dtype)
        return T.alter(img) if fault == "altered" else img

    with torch.no_grad():
        img = sum(shade(c) for c in use) / len(use)
    img_leaf = img.detach().requires_grad_(True)
    loss = phase.loss_of(leaves, img_leaf)
    diff = [leaf for leaf in leaves if leaf.requires_grad]
    gs = torch.autograd.grad(loss, [img_leaf] + diff, allow_unused=True)
    ct = gs[0] / len(use)
    for leaf, g in zip(diff, gs[1:]):
        leaf.grad = torch.zeros_like(leaf) if g is None else g
    for c in use:
        out = shade(c)
        if out.requires_grad:
            out.backward(ct)
    pulled = [(f, leaf.grad) for f, leaf in zip(fields, leaves)
              if f.requires_grad]
    if pulled:
        torch.autograd.backward([f for f, _ in pulled],
                                [g for _, g in pulled])
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in plist]
    if fault != "unchanged":
        phase.opt.step(plist, grads, state)
    return float(loss.detach()), [float(torch.linalg.vector_norm(g))
                                  for g in grads]


def one_step(phase: Phase, key, cfg: T.Cfg, cam, geo, n_groups: int,
             state: dict):
    """One step from the phase's parameters and the optimiser ``state``
    as they stand: (loss, each leaf's gradient norm); the parameters and
    ``state`` are updated in place."""
    traced = trace(phase, key, cfg, cam, geo, T.march_tables(geo), n_groups)
    return _step(phase, state, traced, cfg, cam, geo, torch.float32, None)


def run_steps(phase: Phase, keys, cfg: T.Cfg, cam, geo, n_groups: int,
              dtype=torch.float32, fault=None, trace_every: int = 1) -> dict:
    """``len(keys)`` steps from the phase's starting state, tracing at
    every ``trace_every``-th: losses, each leaf's first gradient (as
    Adam's first moment gives it), each step's gradient norms and each
    leaf's change."""
    tab = T.march_tables(geo)
    names = list(phase.params)
    start = [p.detach().clone() for p in phase.params.values()]
    state = phase.opt.init(list(phase.params.values()))
    losses, grad_norms, first = [], [], None
    traced = None
    for i, key in enumerate(keys):
        if traced is None or i % trace_every == 0:
            traced = None
            traced = trace(phase, key, cfg, cam, geo, tab, n_groups)
        loss, gn = _step(phase, state, traced, cfg, cam, geo, dtype, fault)
        losses.append(loss)
        grad_norms.append(dict(zip(names, gn)))
        if i == 0:
            first = {n: float(torch.linalg.vector_norm(mu)) / (1.0 - 0.9)
                     for n, mu in zip(names, state["mu"])}
    change = {n: float(torch.linalg.vector_norm(p.detach() - s))
              for n, p, s in zip(names, phase.params.values(), start)}
    return dict(losses=losses, first_grad=first, grad_norms=grad_norms,
                change=change)


def step_keys(seed: int, n: int):
    """The keys of a run's first ``n`` steps: fold_in(key(seed), i)."""
    base = rng.key(seed)
    return [rng.fold_in(base, i) for i in range(n)]
