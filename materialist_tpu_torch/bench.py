"""The port's benchmark of its main path, the counterpart of the JAX
package's ``bench.py``: the production inverse step
(``opt/step.py::make_phase_step``, with ``opt/plan.py``'s plan from the
device's memory) at 1024² × 64 spp on the in-repo photo_e2e scene, then
the relight throughput of ``render_final --mode real``.

    python -m materialist_tpu_torch.bench              # on the card
    python -m materialist_tpu_torch.bench --device cpu --cpu-fast \\
        --res 32 --spp 2 --fresh-iters 1 --trace-every 2 \\
        --relight-res 32 --relight-frames 1

Protocol, in ``bench.py``'s order:

* ``value``: the fresh-trace cost (K = 1, a new trace every iteration),
  the mean host time of ``--fresh-iters`` iterations of trace + step, each
  ending in a synchronise; ``fresh_ms_each`` lists them, because calls
  differ widely;
* ``amortized_ms_per_iter``: the mean over a window of ``--trace-every``
  (K) steps that traces once, at its start; ``trace_pass_ms``: one trace
  alone;
* ``relight_fps``: 64-spp denoised passes of ``render_averaged`` at
  ``--relight-res``² per second.

The scene's maps are resized to ``--res`` as ``jax.image.resize(...,
"bilinear")`` resizes them: a triangle filter on half-pixel centres,
widened when it shrinks (``triangle_matrix``). A missing scene file is an
error. On the card the compaction caps are probed first, as ``optimize``
probes them. Diagnostics go to stderr (caps, plan, the card, peak
memory, launches of one fresh iteration by kernel, the device-busy time
of one more iteration under ``torch.profiler``, as a share of that
profiled iteration and of the mean fresh one, its heaviest kernels, and
its device and idle time by the program's spans); the
result line goes to stdout before the relight and again, with
``relight_fps``, after it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from materialist_tpu_torch import device as device_mod
from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.io import exr
from materialist_tpu_torch.ops.color import linear_to_srgb
from materialist_tpu_torch.ops.kernels import _lib
from materialist_tpu_torch.opt import schedules
from materialist_tpu_torch.opt.step import make_phase_step, param_list
from materialist_tpu_torch.render.forward import render_averaged
from materialist_tpu_torch.render.scene import (GBuffer, Materials,
                                                load_best_results,
                                                make_gbuffer)
from materialist_tpu_torch.render.shader import (RenderConfig,
                                                 compact_cap_utilization,
                                                 probe_compact_caps)
from materialist_tpu_torch.utils.profiling import device_summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "output_imgs", "runs", "photo_e2e")
SCENE_FILES = ("depthPred.exr", "gt_image.exr",
               *(os.path.join("best_results", f) for f in (
                   "albedo.exr", "roughness.exr", "metallic.exr",
                   "normal.exr", "envmap.hdr")))
PARAMS = ("albedo", "roughness", "metallic", "normal", "envmap")
LR = 3e-4
OOM_ATTEMPTS = 3
RELIGHT_SPP = 64


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------------------ scene

def triangle_matrix(out_size: int, in_size: int) -> np.ndarray:
    """The (out_size, in_size) weights of ``jax.image.resize(...,
    "bilinear")`` on one axis, computed in float32 in its order: output i
    samples ``(i + 0.5)·in/out - 0.5``; the triangle kernel is widened by
    in/out when shrinking; each output's weights are divided by their
    sum; a sample outside [-0.5, in - 0.5] gets none."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    sample = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.5))
    x = (np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / max(inv_scale, f32(1.0)))
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(np.float64)


def resize(x, res: int) -> np.ndarray:
    """(H, W[, C]) → (res, res, C) float32 through the two fixed
    ``triangle_matrix`` weights, applied in float64."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        x = x[..., None]
    if x.shape[:2] == (res, res):
        return x
    w_y = triangle_matrix(res, x.shape[0])
    w_x = triangle_matrix(res, x.shape[1])
    rows = np.tensordot(w_y, x.astype(np.float64), axes=(1, 0))
    return np.tensordot(rows, w_x, axes=(1, 1)).transpose(0, 2, 1).astype(
        np.float32)


class Scene(NamedTuple):
    cam: Camera
    gbuf: GBuffer
    mats: Materials
    envmap: torch.Tensor   # (16, 32, 3), as stored
    gt: torch.Tensor       # (res, res, 3) linear


def load_scene(scene_dir: str, res: int, device) -> Scene:
    """depthPred.exr, gt_image.exr and best_results/ (no roughness
    remap) of ``scene_dir``, each map resized to res², on ``device``.
    Raises FileNotFoundError if a file is missing."""
    missing = [f for f in SCENE_FILES
               if not os.path.exists(os.path.join(scene_dir, f))]
    if missing:
        raise FileNotFoundError(f"{scene_dir}: missing {', '.join(missing)}")
    mat = load_best_results(os.path.join(scene_dir, "best_results"),
                            roughness_remap=False)
    depth = resize(exr.read(os.path.join(scene_dir, "depthPred.exr"))
                   [..., :1], res)
    gt = resize(exr.read(os.path.join(scene_dir, "gt_image.exr")), res)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    mats = Materials(*(t(resize(mat[k], res)) for k in PARAMS[:4]))
    cam = Camera(res, res)
    gbuf = make_gbuffer(depth[..., 0], cam, flip_depth=True, device=device)
    return Scene(cam, gbuf, mats, t(mat["envmap"]), t(gt))


# ------------------------------------------------------------------- step

def render_config(spp: int, cpu_fast: bool) -> RenderConfig:
    """The bench's render: ``RenderConfig`` defaults at chunk 8;
    ``cpu_fast``: the vectorized "exact" march at 8/8 steps."""
    fast = dict(march_impl="exact", march_vectorized=True, march_steps=8,
                shadow_steps=8) if cpu_fast else {}
    return RenderConfig(spp=spp, chunk=8, **fast)


def maps_of(params, extra):
    return Materials(*(params[k] for k in PARAMS[:4])), params["envmap"]


def make_loss_of(gt_srgb):
    """MSE plus L1 of the sRGB image against ``gt_srgb``."""
    def loss_of(maps, img, extra):
        pred = linear_to_srgb(img)
        loss = (torch.mean((pred - gt_srgb) ** 2)
                + torch.mean(torch.abs(pred - gt_srgb)))
        return loss, loss.detach()
    return loss_of


def make_params(scene: Scene) -> dict:
    """The optimized leaves: the four material maps and the envmap."""
    return {k: v.clone().requires_grad_()
            for k, v in zip(PARAMS, (*scene.mats, scene.envmap))}


def build_step(cfg: RenderConfig, scene: Scene, plan, device):
    """The phase step (``plan=None``: planned from the device's memory)
    and its Adam step."""
    phase = make_phase_step(cfg, scene.cam, scene.gbuf, maps_of,
                            make_loss_of(linear_to_srgb(scene.gt)),
                            plan=plan, device=device)
    log(f"plan: groups={phase.n_groups} chunk={phase.cfg.chunk} "
        f"replay={phase.cfg.replay_blob}")
    return phase, phase.make_step(schedules.adam_plain(LR))


def one_iter(phase, step, params, opt_state, key, records=None):
    """Trace (unless ``records`` are given) and step; the parameters are
    updated in place. Returns (loss, records)."""
    if records is None:
        records = phase.trace_all(params, None, key)
    return step(params, opt_state, None, records)[0], records


# ------------------------------------------------------------------- main

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, else
    its name; "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    if shutil.which("nvidia-smi"):
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(dev)


def _launch_counts():
    return dict(_lib.LAUNCHES), dict(_lib.LAUNCHES_BY_SHAPE)


def _launches_since(before):
    """Kernel launches counted since ``before = _launch_counts()``: by
    kernel, and by "kernel [shape]"."""
    kern, shapes = before
    return ({k: v - kern[k] for k, v in _lib.LAUNCHES.items()
             if v > kern[k]},
            {f"{n} {list(shp)}": v - shapes.get((n, shp), 0)
             for (n, shp), v in _lib.LAUNCHES_BY_SHAPE.items()
             if v > shapes.get((n, shp), 0)})


def _busy(fn, dev: torch.device) -> dict:
    """``profiling.device_summary`` of ``fn()`` under ``torch.profiler``,
    against the (profiled, so slowed) host time. Raises unless the port's
    kernels the profiler saw are those the launch counters counted."""
    from torch.profiler import ProfilerActivity, profile
    before = dict(_lib.LAUNCHES)
    _sync(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    summary = device_summary(prof, (time.perf_counter() - t0) * 1e3)
    counted = sum((v - before[k]) * _lib.KERNELS_PER_LAUNCH.get(k, 1)
                  for k, v in _lib.LAUNCHES.items())
    if summary["port_kernel_launches"] != counted:
        raise RuntimeError(
            f"the profiler saw {summary['port_kernel_launches']} launches "
            f"of the port's kernels {_lib.kernel_names()}, the launch "
            f"counters {counted}")
    return summary


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m materialist_tpu_torch.bench",
        description="The port's inverse step and relight benchmark (see "
                    "the module's docstring).")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--scene", default=SCENE,
                    help="scene dir: depthPred.exr, gt_image.exr, "
                         "best_results/")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--fresh-iters", type=int, default=3)
    ap.add_argument("--trace-every", type=int, default=8)
    ap.add_argument("--cpu-fast", action="store_true",
                    help='the vectorized "exact" march at 8/8 steps')
    ap.add_argument("--no-compact", action="store_true",
                    help="no wavefront compaction on the card")
    ap.add_argument("--relight-res", type=int, default=512)
    ap.add_argument("--relight-frames", type=int, default=10)
    ap.add_argument("--skip-relight", action="store_true")
    args = ap.parse_args(argv)
    for name in ("res", "spp", "fresh_iters", "trace_every", "relight_res",
                 "relight_frames"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be at least 1")
    return args


def main(argv=None) -> dict:
    """Run the bench; returns the diagnostics with the result line
    (``result``) and the relight's launches (``relight_launches``)."""
    args = parse_args(argv)
    dev = device_mod.resolve(args.device)
    res, spp, k_every = args.res, args.spp, args.trace_every
    scene = load_scene(args.scene, res, dev)
    cfg = render_config(spp, args.cpu_fast)
    if dev.type == "cuda" and not args.no_compact:
        cfg = cfg._replace(compact_caps=probe_compact_caps(
            rng.key(99), cfg, scene.cam, scene.gbuf, scene.mats,
            scene.envmap))
        log(f"wavefront compaction caps: {cfg.compact_caps}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    cap_util = {}   # bounce -> largest live count / cap (device)

    def traced(records):
        for b, f in compact_cap_utilization(records[0]):
            cap_util[b] = torch.maximum(cap_util[b], f) if b in cap_util \
                else f
        return records

    def fresh_iter(key):
        """One trace + step; its records are dropped on return."""
        loss, records = one_iter(phase, step, params, opt_state, key)
        traced(records)
        return loss

    # warm-up; on running out of device memory, a more conservative plan
    plan = None
    for attempt in range(OOM_ATTEMPTS):
        phase, step = build_step(cfg, scene, plan, dev)
        params = make_params(scene)
        opt_state = schedules.adam_plain(LR).init(param_list(params))
        try:
            float(fresh_iter(rng.key(0)))
            break
        except torch.cuda.OutOfMemoryError:
            if attempt == OOM_ATTEMPTS - 1:
                raise
        p = phase.plan
        plan = p._replace(groups=min(p.groups * 2, spp),
                          chunk=max(p.chunk // 2, 1), replay_blob=False)
        log(f"out of device memory; retrying with plan {plan}")
        del phase, step, params, opt_state
        torch.cuda.empty_cache()

    # fresh-trace protocol (K = 1): every iteration's records are dropped
    # before the next trace allocates
    fresh_ms_each = []
    for i in range(args.fresh_iters):
        before = _launch_counts()
        t0 = time.perf_counter()
        loss = fresh_iter(rng.key(i + 1))
        _sync(dev)
        fresh_ms_each.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches, launches_by_shape = _launches_since(before)
    fresh_ms = sum(fresh_ms_each) / len(fresh_ms_each)
    if not math.isfinite(float(loss)):
        raise RuntimeError(f"the loss is not finite: {float(loss)}")
    log(f"fresh-trace (K=1) ms/iter = {fresh_ms:.1f} (each: "
        f"{', '.join(f'{t:.1f}' for t in fresh_ms_each)})")

    # amortized protocol (K = trace_every): a window of K steps that
    # traces at its first, so its mean holds exactly one trace pass
    amort_ms, trace_ms = fresh_ms, 0.0
    if k_every > 1:
        t0 = time.perf_counter()
        for i in range(k_every):
            if i == 0:
                loss, records = one_iter(phase, step, params, opt_state,
                                         rng.key(100 + i))
                traced(records)
            else:
                loss, _ = one_iter(phase, step, params, opt_state,
                                   rng.key(100 + i), records=records)
        _sync(dev)
        amort_ms = (time.perf_counter() - t0) / k_every * 1e3
        records = None   # freed before the trace pass allocates
        t1 = time.perf_counter()
        records = traced(phase.trace_all(params, None, rng.key(997)))
        _sync(dev)
        trace_ms = (time.perf_counter() - t1) * 1e3
        records = None
        if not math.isfinite(float(loss)):
            raise RuntimeError(f"the loss is not finite: {float(loss)}")
        log(f"amortized (K={k_every}) ms/iter = {amort_ms:.1f}; one trace "
            f"pass = {trace_ms:.1f}")

    # diagnostics of the fresh step
    report = dict(
        card=_card(dev), groups=phase.n_groups, chunk=phase.cfg.chunk,
        replay_blob=phase.cfg.replay_blob, caps=list(cfg.compact_caps),
        cap_util={b: float(f) for b, f in sorted(cap_util.items())},
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None),
        launches=launches, launches_by_shape=launches_by_shape, busy=None,
        relight_launches=None)
    for b, f in report["cap_util"].items():
        if f >= 0.999:
            log(f"WARNING: compaction cap saturated at bounce {b} (util "
                f"{f:.3f}): live rays are being dropped")
    if dev.type == "cuda":
        # the profiler slows the host many times over: the busy time is
        # also given as a share of the mean unprofiled fresh iteration
        report["busy"] = _busy(lambda: fresh_iter(rng.key(998)), dev)
        report["busy"]["busy_share_of_fresh"] = \
            report["busy"]["busy_ms"] / fresh_ms
    print(json.dumps({"diag": report}), file=sys.stderr, flush=True)

    result = {
        "metric": f"inverse_opt_fresh_trace_ms_per_iter_{res}sq_{spp}spp"
                  "_measured",
        "value": fresh_ms,
        "unit": "ms",
        "amortized_ms_per_iter": amort_ms,
        "trace_every": k_every,
        "trace_pass_ms": trace_ms,
        "fresh_ms_each": fresh_ms_each,
        "relight_fps": None,
        "device": report["card"],
    }
    report["result"] = result
    # the headline first: a failed relight still leaves it printed (and
    # the exit code nonzero)
    print(json.dumps(result), flush=True)

    if not args.skip_relight:
        r = load_scene(args.scene, args.relight_res, dev)
        render_averaged(r.gbuf, r.cam, r.mats, r.envmap, n_iter=1,
                        spp=RELIGHT_SPP)
        before = _launch_counts()
        _sync(dev)
        t2 = time.perf_counter()
        img = render_averaged(r.gbuf, r.cam, r.mats, r.envmap,
                              n_iter=args.relight_frames, spp=RELIGHT_SPP)
        _sync(dev)
        relight_s = time.perf_counter() - t2
        if not np.isfinite(img).all():
            raise RuntimeError("the relit image is not finite")
        report["relight_launches"] = _launches_since(before)[0]
        result["relight_fps"] = args.relight_frames / relight_s
        log(f"relight = {result['relight_fps']:.3f} frames/s "
            f"({args.relight_res}²×{RELIGHT_SPP}spp+denoise); launches "
            f"{report['relight_launches']}")
        print(json.dumps(result), flush=True)
    return report


if __name__ == "__main__":
    main()
