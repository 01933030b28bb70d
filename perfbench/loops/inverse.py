"""Loop ``inverse``: a closed loop of inverse steps, each a fresh trace
(``PhaseStep.trace_all``) then the step from ``make_step`` (shade, loss,
adjoint, optimiser update), then the loss read back to the host. Step i
takes the key fold_in(key(seed), i). The configuration's ``phase`` names
the parameterisation (``perfbench/phases/<phase>.py``).

Set-up runs the traffic's first steps through the same calls on the same
objects, which warms every shape, and records what the check compares:
each step's loss, each leaf's first gradient from the optimiser's first
moment, and each leaf's change over those steps. One step of the window,
drawn from the seed among its first ``window_check_span``, is recorded too: the
parameters and the optimiser's moments before it, its loss, and the
parameters and first moment after it. After the window the plain
reference follows the set-up's steps from the same start, and works the
window step out again from the program's state before it.
"""

from __future__ import annotations

import contextlib
import importlib
import random

import torch

from perfbench.reference import step as ref_step
from perfbench.reference import tracer as T

LABELS = ("trace_all", "step", "readback")


def _leaves(params):
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def render_config(conf: dict):
    from materialist_tpu_torch.render.shader import RenderConfig
    return RenderConfig(spp=conf["spp"], chunk=conf["chunk"],
                        max_depth=conf["max_depth"],
                        march_steps=conf["march_steps"],
                        shadow_steps=conf["shadow_steps"],
                        fine_steps=conf["fine_steps"],
                        shadow_fine_steps=conf["shadow_fine_steps"],
                        film_jitter=conf["film_jitter"])


class Loop:
    unit_name = "step"

    def __init__(self, conf: dict, traffic: dict, seed: int, dev, log):
        from materialist_tpu_torch import rng
        from materialist_tpu_torch.camera import Camera
        from materialist_tpu_torch.opt.step import make_phase_step
        from materialist_tpu_torch.render.scene import make_gbuffer
        from materialist_tpu_torch.render.shader import probe_compact_caps

        from perfbench import inputs

        self.conf, self.traffic, self.seed, self.dev = conf, traffic, seed, dev
        self.rng = rng
        mod = importlib.import_module(f"perfbench.phases.{conf['phase']}")
        self.inp = inputs.load(conf, mod.INPUTS, dev)
        res = conf["film"]
        cam = Camera(res, res)
        gbuf = make_gbuffer(self.inp["depth"], cam, flip_depth=True,
                            device=dev)
        self.ph = mod.build(conf, self.inp, seed, dev)
        cfg = render_config(conf)
        if conf["compact"]:
            cfg = cfg._replace(compact_caps=probe_compact_caps(
                rng.key(conf["probe_key"]), cfg, cam, gbuf, *self.ph.probe))
        self.phase = make_phase_step(cfg, cam, gbuf, self.ph.maps_of,
                                     self.ph.loss_of, device=dev)
        self.step = self.phase.make_step(self.ph.opt)
        self.opt_state = self.ph.opt.init(
            list(_leaves(self.ph.params).values()))
        self.base = rng.key(seed)
        log(f"caps {cfg.compact_caps}; plan: groups {self.phase.n_groups} "
            f"chunk {self.phase.cfg.chunk} replay {self.phase.cfg.replay_blob}")

        # the first steps, recorded for the check, and the window step the
        # check works out again
        n_check = traffic["check_steps"]
        self.sampled = n_check + random.Random(seed).randrange(
            traffic["window_check_span"])
        self.window_step = None
        self.records = None
        leaves = _leaves(self.ph.params)
        start = {k: v.detach().clone() for k, v in leaves.items()}
        self.losses = []
        for i in range(n_check):
            self.unit(i)
            self.losses.append(float(self.loss))
            if i == 0:
                self.first_grad = {
                    k: float(torch.linalg.vector_norm(mu)) / (1.0 - 0.9)
                    for k, mu in zip(leaves, self.opt_state["mu"])}
        self.change = {k: float(torch.linalg.vector_norm(v.detach()
                                                         - start[k]))
                       for k, v in leaves.items()}
        self.next = n_check
        del start

    def _state(self, moments: tuple) -> dict:
        """Copies of the leaves and of the optimiser's ``moments``, by
        leaf name, and its step count."""
        names = list(_leaves(self.ph.params))
        out = {"params": {k: v.detach().clone()
                          for k, v in _leaves(self.ph.params).items()},
               "count": self.opt_state["count"]}
        for m in moments:
            out[m] = {k: t.clone() for k, t in zip(names, self.opt_state[m])}
        return out

    def unit(self, i: int, span=None):
        """Step i; returns what the host reads back (the phase's loss or
        its MSE, as the inverse loop prints it)."""
        span = span or (lambda label: contextlib.nullcontext())
        before = self._state(("mu", "nu")) if i == self.sampled else None
        if self.records is None or i % self.traffic["trace_every"] == 0:
            self.records = None
            with span("trace_all"):
                self.records = self.phase.trace_all(
                    self.ph.params, self.ph.extra,
                    self.rng.fold_in(self.base, i))
        with span("step"):
            self.loss, aux, _ = self.step(self.ph.params, self.opt_state,
                                          self.ph.extra, self.records)
        if self.traffic["trace_every"] == 1:
            self.records = None
        with span("readback"):
            value = float(self.ph.read(aux))
        if before is not None:
            self.window_step = dict(i=i, before=before,
                                    loss=float(self.loss),
                                    after=self._state(("mu",)))
        return value

    def instrument(self, span):
        """Spans inside the program's calls: none for this loop."""
        return contextlib.nullcontext()

    def free(self):
        """Drop the program's state; keep what the check needs."""
        for k in ("phase", "step", "opt_state", "ph", "records", "loss"):
            setattr(self, k, None)

    def check(self, limits: dict, log):
        """The plain reference over the recorded steps: (numbers, ref)."""
        setup = _reference_setup(self.conf, self.inp, self.seed, self.dev)
        ref = reference_steps(self.conf, self.traffic, self.inp, self.seed,
                              self.dev, setup=setup)
        got = dict(losses=self.losses, first_grad=self.first_grad,
                   change=self.change)
        ws = self.window_step
        if ws is not None:
            got["window"] = program_window_step(ws)
            ref["window"] = reference_window_step(
                self.conf, self.inp, self.seed, self.dev, ws, setup)
            log(f"window step {ws['i']}: "
                + ", ".join(f"{k} {v!r}"
                            for k, v in window_gaps(got, ref).items()))
        return compare(got, ref, limits), ref


def program_window_step(ws: dict) -> dict:
    """The recorded window step's loss, each leaf's gradient norm (from
    the first moment before and after it: (mu' − b1·mu) / (1 − b1)) and
    each leaf's change."""
    b, a = ws["before"], ws["after"]
    grad = {k: float(torch.linalg.vector_norm(
        (a["mu"][k].double() - 0.9 * b["mu"][k].double()) / (1.0 - 0.9)))
        for k in b["mu"]}
    change = {k: float(torch.linalg.vector_norm(a["params"][k]
                                                - b["params"][k]))
              for k in b["params"]}
    return dict(loss=ws["loss"], grad=grad, change=change)


def reference_window_step(conf, inp, seed, dev, ws: dict,
                          setup=None) -> dict:
    """The plain reference's window step ``ws["i"]`` from the program's
    parameters and optimiser state before it: its trace with the step's
    key, its loss, each leaf's gradient norm and each leaf's change.
    ``setup``: ``_reference_setup``'s, whose leaves are overwritten."""
    phase, cfg, cam, geo, groups = (
        setup or _reference_setup(conf, inp, seed, dev))
    b = ws["before"]
    with torch.no_grad():
        for k, p in phase.params.items():
            p.copy_(b["params"][k])
    names = list(phase.params)
    state = {"count": b["count"],
             "mu": [b["mu"][k].clone() for k in names],
             "nu": [b["nu"][k].clone() for k in names]}
    key = ref_step.step_keys(seed, ws["i"] + 1)[ws["i"]]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss, gn = ref_step.one_step(phase, key, cfg, cam, geo, groups,
                                     state)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    change = {k: float(torch.linalg.vector_norm(p.detach() - b["params"][k]))
              for k, p in phase.params.items()}
    return dict(loss=loss, grad=dict(zip(names, gn)), change=change)


def reference_steps(conf, traffic, inp, seed, dev, dtype=torch.float32,
                    fault=None, setup=None):
    """The reference's first ``check_steps`` steps of a cell: the phase
    of ``perfbench/reference/phase_<phase>.py``, its own plan and caps
    (``setup``: ``_reference_setup``'s, its leaves at their start)."""
    phase, cfg, cam, geo, groups = (
        setup or _reference_setup(conf, inp, seed, dev))
    keys = ref_step.step_keys(seed, traffic["check_steps"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = dtype != torch.float32
    try:
        return ref_step.run_steps(phase, keys, cfg, cam, geo, groups, dtype,
                                  fault, traffic["trace_every"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _reference_setup(conf, inp, seed, dev):
    """(phase, cfg, cam, geometry, groups) of the reference: the phase of
    ``perfbench/reference/phase_<phase>.py``, its own plan and caps."""
    res = conf["film"]
    cam = T.Cam(res, res)
    geo = T.geometry(inp["depth"], cam)
    cfg = T.Cfg(spp=conf["spp"], chunk=conf["chunk"],
                max_depth=conf["max_depth"], march_steps=conf["march_steps"],
                shadow_steps=conf["shadow_steps"],
                fine_steps=conf["fine_steps"],
                shadow_fine_steps=conf["shadow_fine_steps"],
                film_jitter=conf["film_jitter"])
    caps = probe_caps(conf, inp, cam, geo, cfg) if conf["compact"] else ()
    hbm = (torch.cuda.get_device_properties(dev).total_memory
           if torch.device(dev).type == "cuda" else 16 * 1024 ** 3)
    groups, chunk, replay = ref_step.plan(
        res, conf["spp"], hbm, conf["chunk"], max(conf["max_depth"] - 1, 1),
        caps)
    groups = max(min(groups, conf["spp"]), 1)
    spp_g = max(conf["spp"] // groups, 1)
    cfg = cfg._replace(spp=spp_g, chunk=max(min(chunk, conf["chunk"], spp_g),
                                            1), replay_blob=replay)
    return _reference_phase(conf, inp, seed, dev), cfg, cam, geo, groups


def _reference_phase(conf, inp, seed, dev):
    mod = importlib.import_module(
        f"perfbench.reference.phase_{conf['phase']}")
    return mod.build(inp, conf, seed, dev)


def probe_caps(conf, inp, cam, geo, cfg, margin: float = 1.3):
    """Compaction caps as the program sizes them: the alive fractions of
    one uncompacted chunk of the probe key, times ``margin``, rounded up
    to sixteenths."""
    from perfbench.reference import rng
    mats = (inp["albedo"], inp["roughness"], inp["metallic"], inp["normal"])
    env = inp["envmap"]
    c = cfg._replace(spp=min(cfg.chunk, cfg.spp))
    key = rng.split(rng.key(conf["probe_key"]), 1)[0]
    recs = T.trace_chunk(key, c, cam, geo, T.march_tables(geo),
                         T.pack(*mats), env)
    alive = geo.valid.reshape(-1)[None].expand(recs[0].hit.shape)
    caps = []
    for b in range(cfg.max_depth - 2):
        alive = alive & recs[b].hit
        frac = float(alive.to(torch.float32).mean())
        caps.append(min(max(-(-frac * margin * 16 // 1), 1) / 16.0, 1.0))
    return tuple(caps)


def _gap_of_norms(got: dict, ref: dict, keys):
    """Worst leaf of |‖got‖ − ‖ref‖| over the larger of the leaf's ‖ref‖
    and the median leaf's."""
    vals = sorted(ref[k] for k in ref)
    median = vals[len(vals) // 2] if vals else 0.0
    worst = 0.0
    for k in keys:
        den = max(ref[k], median)
        if den > 0.0:
            worst = max(worst, abs(got[k] - ref[k]) / den)
    return worst


def gaps(losses, grads, changes) -> dict:
    """loss_gap, grad_gap and change_gap (see ``compare``) of ``losses``
    [(program, reference)], ``grads`` [(program, reference) leaf norms]
    and ``changes`` [(program, reference, reference gradient norms of the
    steps)]."""
    change_gap = 0.0
    for g, r, norms in changes:
        moving = []
        for k in r:
            for gn in norms:
                vals = sorted(gn.values())
                if gn[k] > 1e-3 * vals[len(vals) // 2]:
                    moving.append(k)
                    break
        change_gap = max(change_gap, _gap_of_norms(
            g, {k: r[k] for k in moving}, moving))
    return dict(
        loss_gap=max(abs(a - b) / max(abs(b), 1e-30) for a, b in losses),
        grad_gap=max(_gap_of_norms(g, r, r) for g, r in grads),
        change_gap=change_gap)


def window_gaps(got: dict, ref: dict) -> dict:
    """The window step's part of the numbers compared."""
    gw, rw = got["window"], ref["window"]
    return gaps([(gw["loss"], rw["loss"])], [(gw["grad"], rw["grad"])],
                [(gw["change"], rw["change"], [rw["grad"]])])


def compare(got: dict, ref: dict, limits: dict) -> dict:
    """The numbers compared, each with its limit, each the worse of the
    set-up's steps and the window step (where ``ref`` holds one under
    ``"window"``):

    * ``loss_gap``: the largest relative gap of a step's loss;
    * ``grad_gap``: the first gradient's norms, and the window step's,
      worst leaf;
    * ``change_gap``: each leaf's change over the set-up's steps, and over
      the window step, worst leaf among those whose reference gradient is
      above a thousandth of the median leaf's in some step (a leaf with
      none moves by round-off alone).
    """
    nums = gaps(list(zip(got["losses"], ref["losses"])),
                [(got["first_grad"], ref["first_grad"])],
                [(got["change"], ref["change"], ref["grad_norms"])])
    if "window" in ref:
        nums = {k: max(v, window_gaps(got, ref)[k]) for k, v in nums.items()}
    return {k: {"value": v, "limit": limits.get(k)} for k, v in nums.items()}
