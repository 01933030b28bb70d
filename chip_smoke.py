#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA package on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py`` (about six
minutes on an NVIDIA H100, the kernels' build included). It

1. prints the card and its power limit, builds the CUDA kernels from
   ``materialist_tpu_torch/csrc`` and prints the build time;
2. holds every kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, and times kernel, plain version and,
   where one PyTorch call does the same, that call (``Tensor.index_add_``,
   ``torch.index_select``, ``torch.nonzero``). The march, the fused bounce
   and its adjoint, the row gather, the row scatter-add (by caller:
   material adjoint, sky adjoint, compaction scatters), ``compact_sel``,
   the envmap sampler and fetch, the bounce's record (``bounce_record``,
   also at the relight's shape) and the jittered primary vertex
   (``primary_state``, at the main path's and the relight's rows, with and
   without the position) are timed at every shape that holds at
   least a tenth of their launches on the main path, on inputs recorded
   from one compacted trace chunk of the scene (its rays, indices,
   uniforms, packed records and dead rows; the fused bounce's incoming
   throughput and its adjoint's cotangents are seeded noise); the entries
   at M = 4·512² stay beside them as the worst case. Each kernel of path
   10 is held the same way at that path's shapes (those with at least a
   tenth of its launches in one fresh iteration, and its largest), on a
   trace chunk of the bench's 1024² scene recorded at the bench's plan
   and caps; the march and the material adjoint also at their worst case
   at that plan's chunk (8·1024² rays of a seeded depth map). The row
   gather is timed at every shape of a path-10 fresh iteration, at sorted
   seeded indices where its callers' ascend and uniform ones where not,
   with L2 warm and emptied before each call, beside its byte bound and
   its sector bound (the 32-byte sectors the card reads), and is held on
   every route: each compiled-in width and a run-time one, on aligned
   and unaligned views. The
   envmap sampler's rows and columns must equal its plain version's on
   every query, its directions and pdfs lie within 2 units in the last
   place; the bounce's record and the primary vertex must equal their
   plain versions' bit for bit
   (the envmap pdf kernel, which only the generic paths launch, is timed
   at its worst case). The adjoint's envmap gradient is held to a float64 sum of the
   same taps, at those shapes and on a one-hot envmap (every NEE sample
   on one texel) and a 64x64 one, and the whole backward is timed against
   the contraction it replaced. The draws (``threefry_draw``, one kernel
   in three modes) must equal their int64 plain versions bit for bit at
   the 1024² bench's and the 512² relight's streams and at ragged sizes,
   and ``randint`` and ``bernoulli`` on the card the CPU's; each mode is
   timed beside its byte bound and its plain version, and must launch on
   its own path, counted by mode from its launch shape: the lattice on
   the main path, the bits and uniforms in path 8c. A bound is
   ``perfbench/roofline/<counter>.py``'s at the counted launch shape
   where that file has one (not A, A′, F, G, C's sectors, C′ in place).
   This runs after the main path, whose launches by shape it prints
   first, and path 10, on neither of which the bounce's backward may run
   that contraction;
3. drives the paths, each with the launch counters set to 0 just before
   and read just after:
   - path 1, the main path: ``optimize`` at 512²×64 spp on the in-repo
     photo_e2e scene (envmap → rm-material → envmap phases, 7 steps) with
     wavefront compaction at probed caps; it fails if a cap saturates;
   - path 10, the port's bench (``materialist_tpu_torch/bench.py``) through
     its ``main`` at full width, 1024²×64 spp at probed caps, with 2 fresh
     iterations, a window of 2 and 2 relight frames (``bench_path``): its
     times must be finite and positive, no cap may saturate, its step must
     launch every kernel of the main path and its relight A–E and none of
     the gradient's or compaction's;
   - the same without compaction at a smaller depth (3 steps), once
     before and once after the main path, the phase times and peak memory
     of the three runs printed side by side;
   - path 2: a 512² render without NEE (the single march) and its
     gradients;
   - path 3: one envmap and one rm step with ``march_impl="mip"`` (the
     table-lookup kernel);
   - the standalone flat lookup on the scene's mip and fine tables;
   - paths 4 to 6, the forward path, on a temporary copy of the scene
     with a seeded mask, a background image, a sphere and a quad:
     ``render_final`` real at the CLI's defaults (512², 64 spp × 10
     passes, denoised), a material edit and a 3-frame rolling envmap
     (path 4; no launch of the bounce's adjoint, the scatter-add or
     ``compact_sel`` is allowed there), the transparency edit (path 5,
     generic shade, every row gather 20 wide) and object insertion (path 6,
     rasterizer, glass shading over the "exact" march); ms per pass,
     render and denoise apart, and peak memory are printed;
4. renders and differentiates a 64² scene on the card (kernels) and on
   the CPU (plain versions) from the same keys and compares them, for the
   default and the "mip" march, and on the card with compaction against
   without; then the forward path's pieces card against CPU: an averaged
   denoised render, a transparent render, ``shade_glass`` and the "exact"
   march on the seeded rays of the march tests;
5. runs the inverse CLI in its resume mode on a copy of the scene;
6. path 7, predict from a photo: MaterialNet from the in-repo checkpoint
   (``runs/matnet_r5/matnet_scratch.npz``) on photo_e2e's
   ``gt_image.exr`` at 518², held against the same on the CPU (max abs
   <= 1e-3 per map) and against the predictions the JAX package recorded
   (mean abs albedo <= 2e-3, normal <= 8e-3, max abs depth <= 1e-2); the
   full vit-b width with seeded weights at 518² (finite, unit normals,
   non-negative maps) and card against CPU at 70²; each timed (CUDA
   events, profiler device ms), with its peak memory and its bound from
   the operations counted on the forward's shapes, with TF32 off and
   again at PyTorch's default TF32 flags (the CLI's precision: cuDNN's
   convolutions in TF32); then the inverse CLI's ``main`` with
   photo_e2e's predict flags, in this process at PyTorch's default TF32
   flags (A–E must all launch after the prediction; every prediction
   file, config.json, the PLY and best_results/ must be written, and its
   maps lie inside the recorded maps' bounds);
7. path 8, training: MaterialNet's training data rendered on the card
   and the trainers' steps (``train_path``). The step is deterministic
   (``models/train.py::make_train_step``): path 8c runs its first 30
   steps again from a fresh net of the same seed and fails unless the
   losses and the parameters repeat bit for bit;
8. path 9, the multi-device layer on photo_e2e at the main path's width
   (``multi_device_path``): one nccl rank against the unsharded render
   and step; two gloo ranks on the one card through the four asserts of
   ``parallel/dryrun.py``; ``opt/accum.py`` against one backward;

then prints its wall time, one JSON line with each kernel's numbers and,
last, the device line. Any failed check exits nonzero before the JSON lines.
Extra output goes to ``chiprun_out/chip_smoke.log``.

``python3 chip_smoke.py --repeat-8c N [--seeds 1,2]`` runs only path
8c's training (300 steps at PyTorch's default TF32 flags) N times from
the same net, data and keys, then once for each other seed, and prints
each run's loss ratio and whether it repeats the first run bit for bit
(``repeat_scratch``; it fails if a run of the first seed does not); it
prints no result line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

from perfbench import files as perf_files
from perfbench.metrics._common import PEAK_BYTES_PER_S, PEAK_FP32_PER_S

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DEV = "cuda"
H100_TF32_FLOPS = 495e12       # TF32 on the tensor cores, dense
# A's and A′'s own bound: the counter carries the rays, not the march
# steps they need, so perfbench/roofline/march_*.py has none
FLOPS_PER_MARCH_STEP = 24      # project + compare + updates, per step
# threefry_draw's modes, the fourth field of its launch shape
DRAW_MODES = ("bits", "uniform", "lattice")
LOG = []
TF32_DEFAULTS = {}             # PyTorch's own TF32 flags, read at start-up
# kernels of the gradient and of compaction: no launch on a path without
NO_GRAD_NONE_OF = ("shade_bounce_bwd", "row_scatter_add",
                   "row_scatter_add_bf16", "row_scatter_add_coherent",
                   "compact_sel")


def log(*a):
    line = " ".join(str(x) for x in a)
    print(line, flush=True)
    LOG.append(line)


def fail(msg):
    log(f"FAIL: {msg}")
    _flush_log()
    sys.exit(1)


def _flush_log():
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke.log"), "w") as f:
        f.write("\n".join(LOG) + "\n")


class Timed(float):
    """Milliseconds per call between two CUDA events; ``device_ms`` is
    the device time per call that the profiler saw (None: not asked for,
    or the profiler reported no device time)."""
    device_ms = None


def cuda_ms(fn, iters=20, warmup=3, device=False):
    """Time ``fn`` over ``iters`` back-to-back calls. The events span the
    host's launch work too, which dominates kernels of a few tens of
    microseconds; ``device=True`` also sums the device time of every
    kernel of the calls as ``torch.profiler`` reports it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    out = Timed(s.elapsed_time(e) / iters)
    if device:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(ev.device_time_total for ev in _device_events(prof))
        out.device_ms = total_us / iters / 1e3 if total_us > 0 else None
    return out


def kernel_device_ms(fn, flush=False, iters=20, warmup=3):
    """Device ms of the one kernel that each call of ``fn`` launches: the
    mean over the kernels ``torch.profiler`` saw (it can miss some in a
    long run). ``flush``: L2 emptied before each call by a 128 MB fill
    (its kernels left out), the time a caller pays whose inputs come from
    device memory; else back to back, L2 warm. None where it saw under
    half of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    buf = torch.empty(32 * 2 ** 20, device="cuda") if flush else None

    def call(j):
        if flush:
            buf.fill_(float(j))
        fn()
    for j in range(warmup):
        call(j)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for j in range(iters):
            call(j)
        torch.cuda.synchronize()
    evs = [ev for ev in _device_events(prof) if "FillFunctor" not in ev.key]
    seen = sum(ev.count for ev in evs)
    total_us = sum(ev.device_time_total for ev in evs)
    if seen < iters // 2 or total_us <= 0:
        return None
    return total_us / seen / 1e3


def _device_events(prof):
    """The profiler's device operations, without the ranges of user
    annotations (``Optimizer.step#AdamW.step``), whose device span would
    count the kernels inside them twice."""
    return [ev for ev in prof.key_averages()
            if ev.device_type.name == "CUDA"
            and not getattr(ev, "is_user_annotation", False)]


def bound(bytes_moved, flops):
    """(ms, "bytes" | "operations"): the larger of the two at the card's
    peaks, ``perfbench/metrics/_common.py``'s."""
    t_b = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FP32_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def roofline(counter, shape):
    """A launch's bound at the shape its launch counter records, from
    ``perfbench/roofline/<counter>.py``, the one home of a kernel's
    bytes and operations; None where that file has no bound for it."""
    b = perf_files.load("roofline", counter).bound(tuple(shape))
    return None if b is None else bound(*b)


def main():
    import argparse
    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one GPU (see the module's docstring).")
    ap.add_argument("--repeat-8c", type=int, default=0,
                    help="run only path 8c's training, this many times")
    ap.add_argument("--seeds", default="",
                    help="with --repeat-8c: other seeds, once each (1,2)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not os.path.isdir(os.path.join(REPO, "materialist_tpu_torch")):
        fail("materialist_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, REPO)
    from materialist_tpu_torch.models.train import CUBLAS_WORKSPACE
    # path 8's deterministic training step needs cuBLAS's workspace set
    # before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    TF32_DEFAULTS.update(matmul=torch.backends.cuda.matmul.allow_tf32,
                         cudnn=torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda)

    from materialist_tpu_torch.ops.kernels import _lib
    t0 = time.perf_counter()
    _lib.build(verbose=True)
    _lib.lib()
    log(f"build_s {time.perf_counter() - t0:.2f}")
    if args.repeat_8c:
        repeat_scratch(torch, args.repeat_8c,
                       [int(x) for x in args.seeds.split(",") if x])
        _flush_log()
        return

    # B′ sums the envmap gradient on the card: the bounce's backward must
    # not run the one-hot contraction of its plain version there
    from materialist_tpu_torch.ops.kernels import shadebounce as sb
    contraction, contractions = sb._denv_from_dle, []

    def counted(*a):
        contractions.append(1)
        return contraction(*a)
    sb._denv_from_dle = counted
    try:
        main_launches, by_shape, caps = main_path(torch, _lib)
        log("launches by shape: " + json.dumps(
            [{"name": nm, "shape": list(shp), "launches": v}
             for (nm, shp), v in sorted(by_shape.items(),
                                        key=lambda kv: (kv[0][0], -kv[1]))]))
        # path 10 before the kernel rows: they take its shapes and plan
        bench_launches, bench_info = bench_path(torch, _lib)
    finally:
        sb._denv_from_dle = contraction
    if contractions:
        fail(f"_denv_from_dle ran {len(contractions)} times on paths 1 and "
             "10: the bounce's backward left the kernel")
    log("_denv_from_dle: 0 calls on paths 1 and 10 (B′ sums d_env)")
    kernels = check_kernels(torch, _lib, caps, by_shape, bench_info)
    launches = {"main": {**main_launches, **draw_launches(by_shape)},
                "path 10": bench_launches,
                "nee_false": nee_false_path(torch, _lib),
                "mip": mip_path(torch, _lib),
                "standalone": standalone_lookup(torch, _lib)}
    launches.update(forward_paths(torch, _lib))
    small_agreement(torch)
    small_agreement(torch, march_impl="mip")
    compaction_agreement(torch)
    forward_agreements(torch)
    cli_run()
    launches["path 7"] = predict_path(torch, _lib)
    (launches["path 8"], launches["path 8 generate"],
     launches["path 8c"]) = train_path(torch, _lib)
    launches["path 9"] = multi_device_path(torch, _lib, caps, main_launches)

    for k in kernels:
        k["counter_name"] = k["counter"]
        k["launches"] = launches[k["path"]][k.pop("counter")]
        if k["launches"] <= 0:
            fail(f"kernel {k['name']} was not launched on its path "
                 f"({k['path']})")
    for k in kernels:
        k["launches_by_path"] = {
            p: launches[p].get(k["counter_name"])
            for p in ("path 4", "path 5", "path 6", "path 7", "path 8",
                      "path 8 generate", "path 9", "path 10")}
        k.pop("counter_name")
    log("kernels: " + ", ".join(
        f"{k['name']}={'ok' if k['ok'] else 'FAIL'}" for k in kernels))
    log(f"total_s {time.perf_counter() - t_start:.1f}")
    for k in kernels:
        k.pop("ok")
    _flush_log()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# ------------------------------------------------------------------ scene

def photo_scene(torch, dev):
    """The in-repo photo_e2e scene at 512²: gbuffer, materials, envmap."""
    from materialist_tpu_torch.camera import Camera
    from materialist_tpu_torch.io import exr as exr_io
    from materialist_tpu_torch.io import image as image_io
    from materialist_tpu_torch.render.scene import (Materials,
                                                    make_gbuffer)
    d = os.path.join(REPO, "output_imgs", "runs", "photo_e2e")
    br = os.path.join(d, "best_results")
    cam = Camera(512, 512)
    depth = exr_io.read(os.path.join(d, "depthPred.exr"))[..., 0]
    gbuf = make_gbuffer(depth, cam, flip_depth=True, device=dev)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)
    mats = Materials(t(exr_io.read(os.path.join(br, "albedo.exr"))[..., :3]),
                     t(exr_io.read(os.path.join(br, "roughness.exr"))
                       [..., :1]),
                     t(exr_io.read(os.path.join(br, "metallic.exr"))
                       [..., :1]),
                     gbuf.normal_geo)
    env = t(image_io.read(os.path.join(br, "envmap.hdr")))
    return cam, gbuf, mats, env


def seeded_depth_scene(torch, dev):
    """A seeded non-flat 512² depth map (bumps, boxes, a masked corner)
    so the march takes both its hit and its miss branches."""
    from materialist_tpu_torch.camera import Camera
    from materialist_tpu_torch.render.scene import make_gbuffer
    g = torch.Generator().manual_seed(SEED)
    n = 512
    y, x = torch.meshgrid(torch.linspace(0, 1, n), torch.linspace(0, 1, n),
                          indexing="ij")
    depth = 2.0 + 0.3 * torch.sin(6 * math.pi * x) * torch.cos(
        4 * math.pi * y)
    for _ in range(12):
        r0, c0 = torch.randint(0, n - 96, (2,), generator=g).tolist()
        hh, ww = torch.randint(24, 96, (2,), generator=g).tolist()
        depth[r0:r0 + hh, c0:c0 + ww] -= 0.8 * float(
            torch.rand((), generator=g))
    depth += 0.01 * torch.rand((n, n), generator=g)
    mask = torch.zeros((n, n), dtype=torch.bool)
    mask[:64, :128] = True
    cam = Camera(n, n)
    return cam, make_gbuffer(depth, cam, flip_depth=False, mask=mask,
                             device=dev)


def bench_march_scene(torch, dev):
    """The 1024² march scene of ``tests/test_torch_kernels_cuda.py``'s
    check at the bench's chunk (``utils/seeded.py::march_scene``, seed
    0): (cam, gbuf)."""
    from materialist_tpu_torch.camera import Camera
    from materialist_tpu_torch.render.scene import make_gbuffer
    from materialist_tpu_torch.utils.seeded import march_scene
    depth, mask = march_scene(BENCH_RES, 0)
    cam = Camera(BENCH_RES, BENCH_RES)
    return cam, make_gbuffer(depth, cam, flip_depth=False, mask=mask,
                             device=dev)


# ------------------------------------------------------- kernels vs plain

def compare(name, got, ref, atol, rtol, min_frac=1.0):
    """Elementwise |got - ref| <= atol + rtol·|ref| on at least
    ``min_frac`` of the rows (1.0: all of them)."""
    got = got.float()
    ref = ref.float()
    err = (got - ref).abs()
    finite = bool(torch_isfinite_all(got)) and bool(torch_isfinite_all(ref))
    within = (err <= atol + rtol * ref.abs()).reshape(err.shape[0], -1)
    frac = float(within.all(dim=1).float().mean())
    ok = finite and frac >= min_frac
    log(f"  {name}: max_abs_err {float(err.max()):.3e} mean_abs_err "
        f"{float(err.mean()):.3e} (atol {atol:.1e}, rtol {rtol:.1e}; "
        f"{frac:.7f} of rows within, need {min_frac}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok, float(err.max())


def torch_isfinite_all(x):
    import torch
    return torch.isfinite(x).all()


def march_inputs(torch, dev, scene=None, s=4):
    """The march's worst-case input: M = s·n vertices of a seeded
    non-flat depth map of n pixels (``scene`` = (cam, gbuf), by default
    ``seeded_depth_scene``), lobe directions from the BRDF sampler, NEE
    directions from the envmap sampler, the origin a broadcast over the
    s samples. Returns (cam, gbuf, tables, origin, d_lobe, d_nee, kw)."""
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.ops import brdf
    from materialist_tpu_torch.ops import envmap as em
    from materialist_tpu_torch.opt.loop import InverseOptions, _render_cfg
    from materialist_tpu_torch.render import shader
    cam, gbuf = scene or seeded_depth_scene(torch, dev)
    _, _, _, env = photo_scene(torch, dev)
    cfg = _render_cfg(InverseOptions())
    tab = shader.march_tables(cfg, gbuf)
    n = cam.height * cam.width
    k = rng.split(rng.key(SEED), 3)
    u1 = rng.uniform(k[0], (s, n), dev)
    u2 = rng.uniform(k[1], (s, n, 2), dev)
    u_nee = rng.uniform(k[2], (s, n, 2), dev)
    wo = gbuf.wo.reshape(n, 3).expand(s, n, 3)
    d_lobe = brdf.sample_dirs(u1, u2, wo, gbuf.normal_geo.reshape(n, 3),
                              torch.full((n, 1), 0.5, device=dev))
    d_nee, _ = em.sample_dir(em.build_sampler(env), u_nee)
    origin = gbuf.position.reshape(n, 3).expand(s, n, 3)
    kw = dict(n_steps=cfg.march_steps, fine_steps=cfg.fine_steps,
              shadow_steps=cfg.shadow_steps,
              shadow_fine_steps=cfg.shadow_fine_steps, t_min_frac=2e-3,
              t_max_frac=3.0, bias_frac=4e-3,
              interval_frac=cfg.march_interval_frac)
    return cam, gbuf, tab, origin, d_lobe, d_nee, kw


def needed_march_steps(torch, cam, tab, origin, direction, n_steps,
                       fine_steps, shadow_only, t_min_frac=2e-3,
                       t_max_frac=3.0, bias_frac=4e-3):
    """March steps (coarse + fine, summed over the rays) that these rays
    need: a step counts for a ray as long as a value that is read later can
    still change (coarse: fewer rising edges than are read and still inside
    the frustum or past an edge; fine: its interval has an edge and no
    crossing was found yet). It is the work the bound of the march counts."""
    o = origin.reshape(-1, 3)
    d = direction.reshape(-1, 3)
    m = d.shape[0]
    dev = d.device
    h, w = tab.dist.shape
    ratio = (t_max_frac / t_min_frac) ** (1.0 / max(n_steps - 1, 1))

    def project(q):
        uv = cam.project(q)
        ui = torch.floor(uv[..., 0] + 0.5).to(torch.int32)
        vi = torch.floor(uv[..., 1] + 0.5).to(torch.int32)
        return ui, vi, ((ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
                        & (q[..., 2] < 0))

    def cell(ui, vi, f, table):
        th, tw = table.shape
        return (torch.clamp(vi // f, 0, th - 1) * tw
                + torch.clamp(ui // f, 0, tw - 1)).long()

    ui, vi, _ = project(o)
    start = cell(ui, vi, tab.mip_f, tab.mip)
    t = tab.t_lo.expand(m)
    t_prev = t
    tb = [t, t]
    tc = [t, t]
    active = torch.ones((m,), dtype=torch.bool, device=dev)
    prev = torch.zeros_like(active)
    edges = torch.zeros((m,), dtype=torch.int32, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(n_steps):
        steps += active.sum()
        q = o + t[:, None] * d
        ui, vi, inside = project(q)
        mi = cell(ui, vi, tab.mip_f, tab.mip)
        cand = (inside & (-q[:, 2] > tab.mip.reshape(-1)[mi]
                          * (1.0 - bias_frac)) & (mi != start) & active)
        rising = cand & ~prev
        for e in range(2):
            new = rising & (edges == e)
            tb[e] = torch.where(new, t_prev, tb[e])
            tc[e] = torch.where(new, t, tc[e])
        edges = edges + rising.to(torch.int32)
        active = (active & (edges < (1 if shadow_only else 2))
                  & (inside | (edges > 0)))
        prev = cand
        t_prev = t
        t = t * ratio
    if shadow_only:
        return int(steps)
    hit = torch.zeros_like(active)
    for e in range(2):
        for k in range(fine_steps):
            act = (edges > e) & ~hit
            steps += act.sum()
            tt = tb[e] + (tc[e] * ratio - tb[e]) * ((k + 1.0) / fine_steps)
            q = o + tt[:, None] * d
            ui, vi, inside = project(q)
            surf = tab.fine.reshape(-1)[cell(ui, vi, tab.fine_f, tab.fine)]
            hit = hit | (act & inside & (surf < 1.0e29)
                         & (-q[:, 2] > surf * (1.0 + bias_frac)))
    return int(steps)


def capture_trace(torch, scene, cfg, g):
    """One trace chunk of ``scene`` = (cam, gbuf, mats, env) at ``cfg``,
    and the inputs of every march_pair, compact_sel, env_sample_dir,
    env_pdf_dir and bounce_record call of it. Returns a namespace: the
    scene, ``cfg``, ``key``, ``n`` pixels, ``table5`` (the material
    table's first five columns), ``recs`` (the records), ``marches``,
    ``sels`` and ``env_calls`` ({kernel name: calls}), and ``g``, the
    generator of the noise of the checks on it."""
    import types

    from materialist_tpu_torch import rng
    from materialist_tpu_torch.ops.kernels import envkernels as ek
    from materialist_tpu_torch.ops.kernels import march as mk
    from materialist_tpu_torch.render import bsdf as bsdf_mod
    from materialist_tpu_torch.render import shader
    cam, gbuf, mats, env = scene
    key = rng.key(SEED + 1)
    marches, sels = [], []
    env_calls = {"env_sample_dir": [], "env_pdf_dir": [],
                 "bounce_record": []}
    pair, sel = mk.march_pair, shader.compact_sel
    sample, pdf = ek.env_sample_dir, ek.env_pdf_dir
    record = shader.bounce_record

    def rec_pair(cam_, tab, o, dl, dn, **kw):
        marches.append((cam_, tab, o, dl, dn, kw))
        return pair(cam_, tab, o, dl, dn, **kw)

    def rec_sel(alive, cap):
        sels.append((alive, cap))
        return sel(alive, cap)

    def rec_sample(*args):
        env_calls["env_sample_dir"].append(args)
        return sample(*args)

    def rec_pdf(*args):
        env_calls["env_pdf_dir"].append(args)
        return pdf(*args)

    def rec_record(*args):
        env_calls["bounce_record"].append(args)
        return record(*args)

    mk.march_pair, shader.compact_sel = rec_pair, rec_sel
    ek.env_sample_dir, ek.env_pdf_dir = rec_sample, rec_pdf
    shader.bounce_record = rec_record
    try:
        recs = shader._trace_chunk_paths(key, cfg, cam, gbuf, mats, env)
    finally:
        mk.march_pair, shader.compact_sel = pair, sel
        ek.env_sample_dir, ek.env_pdf_dir = sample, pdf
        shader.bounce_record = record
    return types.SimpleNamespace(
        cam=cam, gbuf=gbuf, mats=mats, env=env, cfg=cfg, key=key,
        n=cam.height * cam.width,
        table5=bsdf_mod.disney(mats).table[:, :5], recs=recs,
        marches=marches, sels=sels, env_calls=env_calls, g=g)


def ulp_distance(torch, a, b):
    """Largest distance between two float32 tensors in units in the last
    place (the distance of their bit patterns on the ordered line)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def draw_launches(by_shape) -> dict:
    """``threefry_draw``'s launches by mode (``DRAW_MODES``) in launches
    by shape, under the names ``threefry_draw <mode>``."""
    out = {f"threefry_draw {m}": 0 for m in DRAW_MODES}
    for (name, shape), n in by_shape.items():
        if name == "threefry_draw":
            out[f"threefry_draw {DRAW_MODES[shape[3]]}"] += n
    return out


def check_kernels(torch, _lib, caps, by_shape, bench_info):
    """Every kernel against its plain version at the main path's shapes
    (``by_shape``, on a trace chunk of the photo scene recorded at
    ``caps``) and at path 10's (``bench_info["by_shape"]``, on a trace
    chunk of the bench's 1024² scene recorded at its plan and caps), A and
    the material adjoint also at their worst case at that plan's chunk.
    Returns the kernels line's entries."""
    from materialist_tpu_torch import bench
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.ops import brdf
    from materialist_tpu_torch.ops import envmap as em
    from materialist_tpu_torch.ops.kernels import envkernels as ek
    from materialist_tpu_torch.ops.kernels import gather
    from materialist_tpu_torch.ops.kernels import march as mk
    from materialist_tpu_torch.ops.kernels import rowops
    from materialist_tpu_torch.ops.kernels import shadebounce as sb
    from materialist_tpu_torch.ops.kernels import vreg_gather as vreg
    from materialist_tpu_torch.utils.profiling import gather_sector_bytes
    from materialist_tpu_torch.opt.loop import InverseOptions, _render_cfg
    from materialist_tpu_torch.render import screenspace as ss
    from materialist_tpu_torch.render import shader

    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = []
    rel = "materialist_tpu/ops/pallas/"

    def dev_ms(fn):
        return cuda_ms(fn, device=True)

    def entry(name, src, replaces, ok, err, ms, plain_ms, b,
              library_ms=None, path="main", counter=None, **more):
        """``b``: the headline's (bound ms, by); ``path``: the drive whose
        launch count the entry reports; ``counter``: its key in
        ``_lib.LAUNCHES`` (default: its name)."""
        b_ms, b_by = b
        out.append(dict(name=name, route="cuda",
                        source="materialist_tpu_torch/csrc/" + src,
                        replaces=rel + replaces if replaces else None,
                        launches=0,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                        device_ms=ms.device_ms,
                        library_device_ms=getattr(library_ms, "device_ms",
                                                  None),
                        path=path, counter=counter or name, ok=ok, **more))
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})"
            + (f", library {library_ms:.4f} ms" if library_ms else "")
            + f"; device time: kernel {ms.device_ms} ms"
            + (f", library {library_ms.device_ms} ms" if library_ms else ""))
        if not ok:
            fail(f"kernel {name} disagrees with its plain version")

    def shapes_of(counter, shapes=None):
        """The shapes that hold at least a tenth of a kernel's launches
        on the main path (``shapes``: on path 10, and the largest shape
        there too), most launched (then largest) first:
        [(shape, launches)]."""
        rows = [(shp, v) for (nm, shp), v in (shapes or by_shape).items()
                if nm == counter]
        total = sum(v for _, v in rows)
        if not total:
            fail(f"no launches by shape recorded for {counter}")
        picked = sorted(((shp, v) for shp, v in rows if v >= 0.1 * total),
                        key=lambda r: (-r[1], [-x for x in r[0]]))
        if shapes:
            big = max(rows, key=lambda r: (math.prod(max(x, 1)
                                                     for x in r[0]), r[1]))
            if big not in picked:
                picked.append(big)
        return picked

    def path10_shapes(counter):
        return shapes_of(counter, bench_info["by_shape"])

    log("[kernels] main-path and path-10 shapes, kernel vs plain on the "
        "card")
    cam_p, gbuf_p, mats_p, env = photo_scene(torch, dev)
    s = 4
    n = 512 * 512
    m = s * n
    sampler = em.build_sampler(env)
    cfg = _render_cfg(InverseOptions())
    tr_main = capture_trace(torch, (cam_p, gbuf_p, mats_p, env),
                            cfg._replace(compact_caps=tuple(caps)), g)
    # path 10's: the bench's scene and plan; its noise from its own
    # generator, so the main path's rows keep their inputs
    tr_10 = capture_trace(
        torch, bench.load_scene(bench.SCENE, BENCH_RES, dev)[:4],
        bench.render_config(64, False)._replace(
            compact_caps=tuple(bench_info["caps"]),
            chunk=bench_info["chunk"], replay_blob=bench_info["replay_blob"]),
        torch.Generator(device=dev).manual_seed(SEED + 2 * BENCH_RES))

    # ---- A: march_pair, first on the worst case (a seeded non-flat depth
    # map, M = 4·512², the origin a broadcast over the samples), then at
    # every main-path and path-10 shape on the rays of the recorded trace
    # chunks
    def march_case(tag, cam_, tab_, o, dl, dn, kw, want_hits):
        hit_k, shad_k = mk.march_pair(cam_, tab_, o, dl, dn, **kw)
        hit_p, shad_p = mk.march_pair_plain(cam_, tab_, o, dl, dn, **kw)
        agree = {nm: float((a == b).float().mean()) for nm, a, b in (
            ("hit", hit_k.hit, hit_p.hit), ("idx", hit_k.idx, hit_p.idx),
            ("shadowed", shad_k, shad_p))}
        both = hit_k.hit & hit_p.hit & (hit_k.idx == hit_p.idx)
        t_err = float((hit_k.t - hit_p.t).abs()[both].max()) if both.any() \
            else 0.0
        hit_frac = float(hit_p.hit.float().mean())
        log(f"  march_pair {tag}: flags agree {agree} (>= 0.999), hit "
            f"fraction {hit_frac:.4f}, shadowed fraction "
            f"{float(shad_p.float().mean()):.4f}, t max_abs_err {t_err:.3e} "
            "where both hit")
        ok = all(v >= 0.999 for v in agree.values()) and (
            not want_hits or 0.01 < hit_frac < 0.99)
        ms = dev_ms(lambda: mk.march_pair(cam_, tab_, o, dl, dn, **kw))
        mm = dl.numel() // 3
        shadow_only = kw["shadow_fine_steps"] == 0
        steps = (needed_march_steps(torch, cam_, tab_, o, dl, kw["n_steps"],
                                    kw["fine_steps"], False)
                 + needed_march_steps(torch, cam_, tab_, o, dn,
                                      kw["shadow_steps"],
                                      max(kw["shadow_fine_steps"], 1),
                                      shadow_only))
        full = mm * (kw["n_steps"] + 2 * kw["fine_steps"]
                     + kw["shadow_steps"]
                     + (0 if shadow_only else 2 * kw["shadow_fine_steps"]))
        # two directions in, hit/idx/t/shadowed out, the origin's stored
        # rows (one block when it is a broadcast over the samples), tables
        bytes_moved = (mm * (24 + 10) + 12 * mk._origin_rows(o).shape[0]
                       + 4 * (tab_.mip.numel() + tab_.fine.numel()))
        return dict(ok=ok, t_err=t_err, ms=ms, steps=steps, full=full,
                    bytes=bytes_moved)

    cam_a, gbuf_a, tab, origin, d_lobe, d_nee, kw_a = march_inputs(torch,
                                                                   dev)
    worst = march_case("worst case", cam_a, tab, origin, d_lobe, d_nee, kw_a,
                       True)
    pms = cuda_ms(lambda: mk.march_pair_plain(cam_a, tab, origin, d_lobe,
                                              d_nee, **kw_a),
                  iters=3, warmup=1)

    def a_rows(tr, shapes, where):
        rows = []
        for (shp, count) in shapes:
            call = [c for c in tr.marches if c[3].numel() // 3 == shp[0]]
            if not call:
                fail(f"no recorded march of {shp[0]} rays ({where})")
            r = march_case(f"{where} trace chunk, {shp[0]} rays", *call[0],
                           False)
            b_ms, b_by = bound(r["bytes"], r["steps"] * FLOPS_PER_MARCH_STEP)
            rows.append(dict(shape=list(shp), launches=count, ok=r["ok"],
                             ms=r["ms"], device_ms=r["ms"].device_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=r["t_err"], steps_needed=r["steps"],
                             steps_full=r["full"]))
            log(f"    {where}: {shp[0]} rays x {count} launches: device "
                f"{r['ms'].device_ms} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"steps needed {r['steps']} of {r['full']}")
        return rows
    a_shapes = a_rows(tr_main, shapes_of("march_pair"), "main")
    a_10 = a_rows(tr_10, path10_shapes("march_pair"), "path 10")
    # the worst case of the 1024² bench (path 10): M = its plan's chunk ·
    # 1024² vertices of the CUDA test's seeded 1024² depth map; the hit
    # indices it gives are the material adjoint's worst case below
    m_big = bench_info["chunk"] * BENCH_RES ** 2
    inp_b = march_inputs(torch, dev, bench_march_scene(torch, dev),
                         bench_info["chunk"])
    big = march_case(f"1024² bench chunk, {m_big} rays", inp_b[0],
                     *inp_b[2:], True)
    if not big["ok"]:
        fail(f"march_pair disagrees at {m_big} rays")
    b_ms, b_by = bound(big["bytes"], big["steps"] * FLOPS_PER_MARCH_STEP)
    a_big = dict(shape=[m_big], ms=big["ms"], device_ms=big["ms"].device_ms,
                 plain_ms=cuda_ms(lambda: mk.march_pair_plain(
                     inp_b[0], *inp_b[2:6], **inp_b[6]), iters=3, warmup=1),
                 bound_ms=b_ms, bound_by=b_by, max_abs_err=big["t_err"],
                 steps_needed=big["steps"], steps_full=big["full"])
    log(f"    {m_big} rays: {big['ms']:.4f} ms, device "
        f"{big['ms'].device_ms} ms, plain {a_big['plain_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), steps needed {big['steps']} of "
        f"{big['full']}")
    hit_big = mk.march_pair(inp_b[0], *inp_b[2:6], **inp_b[6])[0]
    idx_big = hit_big.idx.reshape(m_big).to(torch.int32).contiguous()
    hit_big = hit_big.hit.reshape(m_big, 1)
    del inp_b
    entry("march_pair", "march_pair.cu", "march_kernel.py:505",
          worst["ok"] and all(x.pop("ok") for x in a_shapes + a_10),
          worst["t_err"], worst["ms"], pms,
          bound(worst["bytes"], worst["steps"] * FLOPS_PER_MARCH_STEP),
          by_shape=a_shapes, by_shape_path10=a_10, steps_needed=worst["steps"],
          steps_full=worst["full"], worst_case_1024=a_big)

    def shape_rows(counter, case_of):
        """One row per main-path shape of ``counter``, and one per path-10
        shape: (main rows, path-10 rows). case_of(shape, trace) gives
        dict(run=the kernel call, check=() -> (ok, max_abs_err))."""
        out_rows = []
        for tr, shapes, where in (
                (tr_main, shapes_of(counter), "main"),
                (tr_10, path10_shapes(counter), "path 10")):
            out_rows.append([case_row(case_of(shp, tr), counter, shp,
                                      count, f"{where}: {counter}")
                             for shp, count in shapes])
        return out_rows

    def case_row(c, counter, shp, count, what):
        """Check and time one case of ``counter`` at launch shape ``shp``;
        ``c["extra"]``, where given, adds more timed columns to its row."""
        ok, err = c["check"]()
        ms = dev_ms(c["run"])
        b_ms, b_by = roofline(counter, shp)
        row = dict(shape=list(shp), launches=count, ok=ok, max_abs_err=err,
                   ms=ms, device_ms=ms.device_ms, bound_ms=b_ms,
                   bound_by=b_by)
        log(f"    {what} {list(shp)} x {count} launches: {ms:.4f} ms, "
            f"device {ms.device_ms} ms, bound {b_ms:.4f} ms ({b_by})")
        if "extra" in c:
            row.update(c["extra"]())
        return row

    def all_ok(rows):
        return all(r.pop("ok") for r in rows)

    # ---- B / B′: the worst case is an uncompacted bounce 1 of the photo
    # scene at M = 4·512² rows; then every main-path shape on the packed
    # records of the compacted trace chunk (bounce 0 in full, bounces 1
    # and 2 at their caps)
    recs = shader._trace_chunk_paths(rng.key(SEED + 1), cfg, cam_p, gbuf_p,
                                     mats_p, env)
    r0, r1 = recs[0], recs[1]
    wo_d = -shader._normalize9(r0.aux[..., 0:3].float())
    auxf = torch.cat([wo_d.to(torch.bfloat16), r1.aux], -1).reshape(m, 8)
    blob = r1.blob.float().reshape(m, 5).contiguous()
    thr = torch.rand((m, 3), generator=g, device=dev)
    nrmf = r1.nrm.reshape(m, 3).contiguous()
    recb = r1.recb.reshape(m, 13).contiguous()
    envc = env.contiguous()
    args = (envc, blob, thr, nrmf, auxf.contiguous(), recb)

    def shade_inputs(mm, tr):
        """The fused bounce's arguments of the bounce of trace ``tr`` that
        ran ``mm`` rows, assembled as the shade pass assembles them,
        except the incoming throughput, which is seeded uniform noise (as
        the adjoint's cotangents are seeded normal noise): the bounces
        before are not replayed, and neither time nor agreement hangs on
        them."""
        b = [i for i, r in enumerate(tr.recs) if r.aux.numel() // 5 == mm]
        if not b:
            fail(f"no recorded bounce of {mm} rows")
        b = b[0]
        rec = tr.recs[b]
        tgt = rec.aux.shape[:-1]
        if b == 0 and tr.cfg.film_jitter > 0.0:
            _, _, wo_b, _ = shader._primary_state(
                tr.key, tr.cfg, tr.cam, tr.gbuf, tr.cfg.chunk)
            blob_b = tr.table5.expand(tgt + (5,))
        elif b == 0:
            wo_b = tr.gbuf.wo.reshape(tr.n, 3)
            blob_b = tr.table5.expand(tgt + (5,))
        else:
            w_prev = tr.recs[b - 1].aux[..., 0:3].float()
            if rec.extras is not None:
                w_prev = rowops.gather_rows_coherent(w_prev.reshape(-1, 3),
                                                     rec.extras[0])[None]
            wo_b = -shader._normalize9(w_prev)
            blob_b = rec.blob.float()
        aux_b = torch.cat([wo_b.expand(tgt + (3,)).to(torch.bfloat16),
                           rec.aux], -1)
        return (tr.env.contiguous(), blob_b.reshape(mm, 5).contiguous(),
                torch.rand((mm, 3), generator=tr.g, device=dev),
                rec.nrm.reshape(mm, 3).contiguous(),
                aux_b.reshape(mm, 8).contiguous(),
                rec.recb.reshape(mm, 13).contiguous())

    def fwd_check(a):
        tk, rk = sb.shade_bounce_fwd(*a)
        tp, rp = sb.shade_bounce_fwd_plain(*a)
        ok1, e1 = compare("shade_bounce_fwd thr'", tk, tp, 1e-5 * float(
            tp.abs().max()), 1e-4)
        ok2, e2 = compare("shade_bounce_fwd rad", rk, rp, 1e-5 * float(
            rp.abs().max()), 1e-4)
        return ok1 and ok2, max(e1, e2)

    def bwd_check(a, ct_t, ct_r):
        """B′ against its plain version: d_blob and d_thr against the
        explicit adjoint; d_env against a float64 sum of the same taps
        (``denv_taps`` of the explicit d_le), within 8 times the distance
        of the float32 plain version (``_denv_from_dle``) from that sum,
        or 1e-6 of the largest bin (8 float32 ulps) where that is larger:
        the kernel sums in another order, partly by atomics. Returns (ok,
        max abs error, the d_env numbers)."""
        d_blob, d_thr, d_env = sb.shade_bounce_bwd(*a, ct_t, ct_r)
        p_blob, p_thr, d_le = sb.shade_bounce_bwd_explicit(*a, ct_t, ct_r)
        oks, errs = [], []
        for nm, x, y in (("d_blob", d_blob, p_blob), ("d_thr", d_thr, p_thr)):
            o, e = compare(f"shade_bounce_bwd {nm}", x, y,
                           1e-5 * float(y.abs().max()), 1e-4)
            oks.append(o)
            errs.append(e)
        h, w = a[0].shape[:2]
        ref = sb.denv_taps(h, w, a[5], d_le)
        e_plain = float((sb._denv_from_dle(a[0], a[5], d_le).double()
                         - ref).abs().max())
        e_env = float((d_env.double() - ref).abs().max())
        limit = max(8 * e_plain, 1e-6 * float(ref.abs().max()))
        o = bool(torch.isfinite(d_env).all()) and e_env <= limit
        log(f"  shade_bounce_bwd d_env: max_abs_err {e_env:.3e} from the "
            f"float64 tap sum; float32 contraction {e_plain:.3e}; limit "
            f"{limit:.3e} (largest bin {float(ref.abs().max()):.3e}) "
            f"{'ok' if o else 'FAIL'}")
        return all(oks) and o, max(errs), dict(
            d_env_err=e_env, d_env_err_contraction=e_plain,
            d_env_limit=limit)

    def fwd_case(shp, tr):
        a = shade_inputs(shp[0], tr)
        return dict(run=lambda: sb.shade_bounce_fwd(*a),
                    check=lambda: fwd_check(a))

    def bwd_case(shp, tr):
        """B′ with d_env, as the envmap phases call it; the extra columns
        time it without d_env (the material phases) and the backward it
        replaced: B′ without d_env, then the one-hot contraction on the
        explicit d_le (the old kernel also wrote d_le, 24 B a row, which
        this leaves out)."""
        a = shade_inputs(shp[0], tr)
        ct = [torch.randn((shp[0], 3), generator=tr.g, device=dev)
              for _ in range(2)]
        info = {}

        def check():
            ok, err, more = bwd_check(a, *ct)
            info.update(more)
            return ok, err

        def extra():
            d_le = sb.shade_bounce_bwd_explicit(*a, *ct)[2]
            no_env = dev_ms(lambda: sb.shade_bounce_bwd(*a, *ct,
                                                        env_grad=False))
            old = dev_ms(lambda: (
                sb.shade_bounce_bwd(*a, *ct, env_grad=False),
                sb._denv_from_dle(a[0], a[5], d_le)))
            log(f"      without d_env {no_env:.4f} ms, device "
                f"{no_env.device_ms} ms; the replaced backward (B′, then "
                f"_denv_from_dle) {old:.4f} ms, device {old.device_ms} ms")
            return dict(info, ms_no_env=no_env,
                        device_ms_no_env=no_env.device_ms, old_ms=old,
                        old_device_ms=old.device_ms)

        return dict(run=lambda: sb.shade_bounce_bwd(*a, *ct), check=check,
                    extra=extra, args=a)

    ok, err = fwd_check(args)
    ms = dev_ms(lambda: sb.shade_bounce_fwd(*args))
    pms = cuda_ms(lambda: sb.shade_bounce_fwd_plain(*args), iters=5)
    rows_b, rows_10 = shape_rows("shade_bounce_fwd", fwd_case)
    entry("shade_bounce_fwd", "shadebounce.cu", "shadebounce.py:267",
          ok and all_ok(rows_b + rows_10), err, ms, pms,
          roofline("shade_bounce_fwd", (m, *envc.shape[:2])),
          by_shape=rows_b, by_shape_path10=rows_10)

    ct_t = torch.randn((m, 3), generator=g, device=dev)
    ct_r = torch.randn((m, 3), generator=g, device=dev)
    ok, err, env_err = bwd_check(args, ct_t, ct_r)
    ms = dev_ms(lambda: sb.shade_bounce_bwd(*args, ct_t, ct_r))
    pms = cuda_ms(lambda: sb.shade_bounce_bwd_plain(*args, ct_t, ct_r),
                  iters=5)
    rows_b, rows_10 = shape_rows("shade_bounce_bwd", bwd_case)
    # d_env's hard cases, on bounce 0 of a trace chunk at the main path's
    # caps (4·512² rows): a one-hot envmap, whose NEE samples nearly all
    # land on one texel, so most lanes of a warp add to one bin, and a
    # 64x64 envmap (its emitter and one table for the block: 112 KB of
    # shared memory)
    hot = torch.zeros_like(envc)
    hot.view(-1, 3)[int(envc.sum(-1).argmax())] = 10.0
    env64 = torch.nn.functional.interpolate(
        envc.permute(2, 0, 1)[None], size=(64, 64), mode="bilinear",
        align_corners=False)[0].permute(1, 2, 0).contiguous()
    env_cases = []
    for tag, e in (("one-hot envmap", hot), ("64x64 envmap", env64)):
        tr_e = capture_trace(
            torch, (cam_p, gbuf_p, mats_p, e),
            cfg._replace(compact_caps=tuple(caps)),
            torch.Generator(device=dev).manual_seed(SEED + 3))
        shp = (m, e.shape[0], e.shape[1])
        c = bwd_case(shp, tr_e)
        rb, on = c["args"][5], c["args"][4][:, 6].float() > 0
        bins = (rb[:, 10].float() * e.shape[1] + rb[:, 9].float()).long()
        share = float(torch.bincount(bins[on]).max()) / max(int(on.sum()), 1)
        log(f"    {tag}: {share:.4f} of the NEE looks on one base tap")
        env_cases.append(dict(case=tag, nee_top_bin_share=share,
                              **case_row(c, "shade_bounce_bwd", shp, 0,
                                         f"{tag}: shade_bounce_bwd")))
        del tr_e, c
    entry("shade_bounce_bwd", "shadebounce.cu", "shadebounce.py:297",
          ok and all_ok(rows_b + rows_10 + env_cases), err, ms, pms,
          roofline("shade_bounce_bwd", (m, *envc.shape[:2])),
          by_shape=rows_b, by_shape_path10=rows_10, env_cases=env_cases,
          **env_err)

    # ---- C′ by caller. Each is checked and timed at every main-path
    # shape on the recorded chunk's indices, its dead rows zero; the
    # material adjoint also at its worst case (M = 4·512², noise in every
    # row, the uncompacted bounce-0 hit indices, most of them 0)
    def scatter_case(tag, cot, idx, rows, exact, coherent=False, base=None):
        """Kernel against plain version and index_add_; ``base``: the
        running table of an in-place call."""
        def run():
            return rowops.row_scatter_add(
                cot, idx, rows, exact=exact, coherent=coherent,
                out=None if base is None else acc)
        acc = None if base is None else base.clone()
        ck = run()
        cp = rowops.row_scatter_add_plain(cot, idx, rows, exact=exact)
        if base is not None:
            cp = base + cp
        o, e = compare(tag, ck, cp, 1e-5 * float(cp.abs().max()), 1e-5)
        ms = dev_ms(run)
        il = idx.long()
        cb = cot if exact else cot.to(torch.bfloat16).float()
        if base is None:
            lib_ms = dev_ms(lambda: torch.zeros(
                (rows, cot.shape[1]), device=dev).index_add_(0, il, cb))
        else:
            lib_ms = dev_ms(lambda: acc.index_add_(0, il, cb))
        live = int((cot != 0).any(-1).sum())
        touched = int(torch.unique(il[(cot != 0).any(-1)]).numel())
        # chip_smoke's own bound into a running table: the roofline has
        # none, the rows it reads and writes being those it touches
        own = None if base is None else bound(
            cot.numel() * 4 + idx.numel() * 4
            + 2 * touched * cot.shape[1] * 4, 0)
        return dict(ok=o, err=e, ms=ms, lib=lib_ms, own=own, live=live,
                    touched=touched)

    def compacted_bounce(cap, tr):
        """(sel, count, vertex idx, film idx) of the bounce of trace ``tr``
        that was compacted to ``cap`` rows."""
        for r in tr.recs:
            if r.extras is not None and r.extras[0].shape[0] == cap:
                return r.extras
        fail(f"no recorded bounce of {cap} compacted rows")

    def by_shape_rows(counter, make):
        """One row per main-path shape of ``counter``, and one per path-10
        shape: (main rows, path-10 rows). make(shape, trace) gives the
        arguments of scatter_case."""
        out_rows = []
        for tr, shapes, where in (
                (tr_main, shapes_of(counter), "main"),
                (tr_10, path10_shapes(counter), "path 10")):
            rows = []
            for shp, count in shapes:
                r = scatter_case(f"{where}: {counter} {shp}",
                                 **make(shp, tr))
                r["b"] = roofline(counter, shp) or r["own"]
                b_ms = r["b"][0]
                rows.append(dict(shape=list(shp), launches=count, r=r,
                                 ms=r["ms"], device_ms=r["ms"].device_ms,
                                 library_ms=r["lib"],
                                 library_device_ms=r["lib"].device_ms,
                                 bound_ms=b_ms, live_rows=r["live"],
                                 rows_touched=r["touched"],
                                 max_abs_err=r["err"]))
                log(f"    {where}: {counter} {shp} x {count} launches: "
                    f"{r['live']} live rows onto {r['touched']}, device "
                    f"{r['ms'].device_ms} ms, bound {b_ms:.4f} ms, "
                    f"index_add_ {r['lib'].device_ms} ms")
            out_rows.append(rows)
        return out_rows

    def dead_rows_zero(cot, count):
        live = torch.arange(cot.shape[0], device=dev) < count
        return torch.where(live[:, None], cot, 0.0)

    def scatter_entry(name, rows, plain_args, **more):
        """The entry of one caller: its most launched main-path shape, the
        others and path 10's beside it."""
        rows, rows_10 = rows
        first = rows[0]["r"]
        pms = cuda_ms(lambda: rowops.row_scatter_add_plain(*plain_args),
                      iters=3, warmup=1)
        ok = all(x.pop("r")["ok"] for x in rows + rows_10)
        entry(name, "rowops.cu", "rowops.py:189", ok, first["err"],
              first["ms"], pms, first["b"], library_ms=first["lib"],
              by_shape=rows, by_shape_path10=rows_10, **more)

    # material adjoint: bf16 payload, (cap, 8) rows onto the material table
    def material(shp, tr):
        _, count, vtx, _ = compacted_bounce(shp[0], tr)
        cot = torch.randn((shp[0], 8), generator=tr.g, device=dev)
        cot[:, 5:] = 0.0
        return dict(cot=dead_rows_zero(cot, count), idx=vtx.contiguous(),
                    rows=shp[2], exact=False)
    rows_m = by_shape_rows("row_scatter_add_bf16", material)
    idx_m = r0.idx.reshape(m).to(torch.int32).contiguous()
    cot_m = torch.randn((m, 8), generator=g, device=dev)
    cot_m[:, 5:] = 0.0
    wc = scatter_case("row_scatter_add_bf16 worst case", cot_m, idx_m, n,
                      False)
    if not wc["ok"]:
        fail("row_scatter_add_bf16 disagrees on its worst case")
    # and at the 1024² bench's chunk, onto the 1024² material table at
    # the big march's indices: noise (path 10's generator, so the main
    # path's rows keep their inputs) in the rows that hit, zero in the rest,
    # as on the path, where the cotangent of a vertex that missed is zero
    # (tests/test_torch_bench.py::
    # test_missed_vertices_carry_no_material_cotangent). Noise there would
    # pile ~4.8 M terms onto row 0, whose float32 sum then differs by its
    # order alone by ~1e-2, at 1e-5 of the table's largest value; the
    # 4·512² row keeps such a pile-up (0.65 M terms)
    cot_b = torch.randn((m_big, 8), generator=tr_10.g, device=dev)
    cot_b[:, 5:] = 0.0
    cot_b = torch.where(hit_big, cot_b, 0.0)
    wb = scatter_case(f"row_scatter_add_bf16 1024² bench chunk, {m_big} "
                      "rows", cot_b, idx_big, BENCH_RES ** 2, False)
    if not wb["ok"]:
        fail(f"row_scatter_add_bf16 disagrees at {m_big} rows")
    c_big = dict(shape=[m_big, 8, BENCH_RES ** 2], ms=wb["ms"],
                 device_ms=wb["ms"].device_ms, plain_ms=cuda_ms(
                     lambda: rowops.row_scatter_add_plain(
                         cot_b, idx_big, BENCH_RES ** 2, False),
                     iters=3, warmup=1),
                 library_ms=wb["lib"], library_device_ms=wb["lib"].device_ms,
                 bound_ms=roofline("row_scatter_add_bf16",
                                   (m_big, 8, BENCH_RES ** 2))[0],
                 rows_touched=wb["touched"], max_abs_err=wb["err"])
    log(f"    {m_big} rows onto {wb['touched']}: {wb['ms']:.4f} ms, device "
        f"{wb['ms'].device_ms} ms, plain {c_big['plain_ms']:.4f} ms, bound "
        f"{c_big['bound_ms']:.4f} ms, index_add_ {wb['lib'].device_ms} ms")
    del cot_b, idx_big, hit_big
    first = material(rows_m[0][0]["shape"], tr_main)
    scatter_entry("row_scatter_add_bf16", rows_m,
                  (first["cot"], first["idx"], first["rows"], False),
                  worst_case=dict(
                      shape=[m, 8, n], ms=wc["ms"],
                      device_ms=wc["ms"].device_ms, library_ms=wc["lib"],
                      library_device_ms=wc["lib"].device_ms,
                      bound_ms=roofline("row_scatter_add_bf16",
                                        (m, 8, n))[0],
                      rows_touched=wc["touched"], max_abs_err=wc["err"]),
                  worst_case_1024=c_big)

    # sky adjoint: exact, the four bilinear taps of every pixel's sky
    # lookup onto the 16 x 32 emitter (a table of 6 KB)
    sky_of = {}

    def sky(shp, tr):
        if tuple(shp) != (4 * tr.n, 3, 512):
            fail(f"unexpected shape of the exact scatter-add: {shp}")
        if id(tr) not in sky_of:
            u0, v0, du, dv = em.bilinear_coords(
                -tr.gbuf.wo.reshape(tr.n, 3), 16, 32)
            ew = tr.env.shape[1]
            taps = ((v0, u0, (1 - du) * (1 - dv)),
                    (v0, (u0 + 1) % ew, du * (1 - dv)),
                    (torch.clamp(v0 + 1, 0, 15), u0, (1 - du) * dv),
                    (torch.clamp(v0 + 1, 0, 15), (u0 + 1) % ew, du * dv))
            base_s = torch.randn((tr.n, 3), generator=tr.g, device=dev)
            sky_of[id(tr)] = (
                torch.cat([wt[:, None] * base_s for _, _, wt in taps]),
                torch.cat([(vi * ew + ui).reshape(-1)
                           for vi, ui, _ in taps]).to(torch.int32))
        cot_s, idx_s = sky_of[id(tr)]
        return dict(cot=cot_s, idx=idx_s, rows=512, exact=True)
    scatter_entry("row_scatter_add", by_shape_rows("row_scatter_add", sky),
                  (*sky_of[id(tr_main)], 512, True))
    sky_of.clear()

    # compaction scatters: exact, live indices ascending and unique. Shape
    # (cap, 3, rows, 1): the film accumulation, in place onto the (M, 3)
    # buffer at the film indices; (cap, 3, rows, 0): the throughput
    # adjoint onto the previous bounce's rows at sel
    def compaction(shp, tr):
        sel, count, _, film = compacted_bounce(shp[0], tr)
        cot = dead_rows_zero(torch.randn((shp[0], 3), generator=tr.g,
                                         device=dev), count)
        if shp[3]:
            return dict(cot=cot, idx=film.contiguous(), rows=shp[2],
                        exact=True, coherent=True,
                        base=torch.randn((shp[2], 3), generator=tr.g,
                                         device=dev))
        return dict(cot=cot, idx=sel, rows=shp[2], exact=True, coherent=True)
    rows_c = by_shape_rows("row_scatter_add_coherent", compaction)
    first = compaction(rows_c[0][0]["shape"], tr_main)
    scatter_entry("row_scatter_add_coherent", rows_c,
                  (first["cot"], first["idx"], first["rows"], True))

    # ---- compact_sel: the trace's own flags at every main-path shape,
    # then none alive, all alive and more alive than the cap; sel and
    # count equal to the plain version's as integers
    def sel_case(tag, alive, cap):
        sel_k, cnt_k = rowops.compact_sel(alive, cap)
        sel_p, cnt_p = rowops.compact_sel_plain(alive, cap)
        same = bool(torch.equal(sel_k, sel_p)) and int(cnt_k) == int(cnt_p)
        log(f"  compact_sel {tag}: {int(cnt_p)} of {alive.numel()} into cap "
            f"{cap}, equal to its plain version: {same}")
        if not same:
            fail(f"compact_sel disagrees with its plain version ({tag})")

    def sel_rows(tr, shapes, where):
        rows = []
        for shp, count in shapes:
            call = [c for c in tr.sels
                    if (c[0].numel(), c[1]) == tuple(shp)]
            if not call:
                fail(f"no recorded compact_sel of shape {shp} ({where})")
            alive, cap = call[0]
            sel_case(f"{where} trace flags {shp}", alive, cap)
            ms = dev_ms(lambda: rowops.compact_sel(alive, cap))
            lib = dev_ms(lambda: torch.nonzero(alive))
            b_ms = roofline("compact_sel", shp)[0]
            rows.append(dict(shape=list(shp), launches=count, ms=ms,
                             device_ms=ms.device_ms, library_ms=lib,
                             library_device_ms=lib.device_ms, bound_ms=b_ms))
            log(f"    {where}: compact_sel {shp} x {count} launches: "
                f"{ms:.4f} ms, device {ms.device_ms} ms, bound {b_ms:.5f} "
                f"ms, nonzero {lib:.4f} ms, device {lib.device_ms} ms")
        return rows
    rows_s = sel_rows(tr_main, shapes_of("compact_sel"), "main")
    rows_10 = sel_rows(tr_10, path10_shapes("compact_sel"), "path 10")
    alive0, cap0 = [c for c in tr_main.sels if c[0].numel() == m][0]
    sel_case("none alive", torch.zeros_like(alive0), cap0)
    sel_case("all alive", torch.ones_like(alive0), m)
    sel_case("more alive than the cap", torch.ones_like(alive0), cap0)
    sel_case("M not a multiple of 16, unaligned", alive0[3:m - 1001], cap0)
    pms = cuda_ms(lambda: rowops.compact_sel_plain(alive0, cap0), iters=5)
    entry("compact_sel", "rowops.cu", "rowops.py:189", True, 0.0,
          rows_s[0]["ms"], pms, roofline("compact_sel", rows_s[0]["shape"]),
          library_ms=rows_s[0]["library_ms"], by_shape=rows_s,
          by_shape_path10=rows_10,
          jax_function="materialist_tpu/ops/pallas/rowops.py:344")

    # ---- D, D′, E: the worst case at M = 4·512² seeded uniforms and the
    # lobe directions of the seeded depth map; then every main-path shape
    # on the arguments the compacted trace chunk gave the kernels. D: row
    # and column equal to the plain version's on every query, wi and pdf
    # within 2 units in the last place of it
    tabs = (sampler.m_cdf, sampler.m_pdf, sampler.c_cdf, sampler.c_pdf)
    eh, ew = sampler.c_cdf.shape

    def sample_check(u2):
        tex_k = ek.env_sample_texels(*tabs, u2)
        tex_p = ek.env_sample_texels_plain(sampler.m_cdf, sampler.c_cdf, u2)
        wk, pk = ek.env_sample_dir(*tabs, u2)
        wp, pp = ek.env_sample_dir_plain(*tabs, u2)
        same = bool(torch.equal(tex_k, tex_p))
        ulps = max(ulp_distance(torch, wk, wp), ulp_distance(torch, pk, pp))
        err = max(float((wk - wp).abs().max()), float((pk - pp).abs().max()))
        log(f"  env_sample_dir {tuple(u2.shape)}: rows and columns equal to "
            f"the plain version's: {same}; wi, pdf at most {ulps} ulp from "
            f"it (allowed 2), max_abs_err {err:.3e}")
        return same and ulps <= 2, err

    def recorded(name, mm, tr):
        call = [c for c in tr.env_calls[name]
                if c[-1].numel() // c[-1].shape[-1] == mm]
        if not call:
            fail(f"no recorded {name} call of {mm} queries")
        return call[0]

    def sample_case(shp, tr):
        u2 = recorded("env_sample_dir", shp[0], tr)[-1]
        return dict(run=lambda: ek.env_sample_dir(*tabs, u2),
                    check=lambda: sample_check(u2))

    u_s = rng.uniform(rng.key(SEED + 2), (m, 2), dev)
    ok, err = sample_check(u_s)
    ms = dev_ms(lambda: ek.env_sample_dir(*tabs, u_s))
    pms = cuda_ms(lambda: ek.env_sample_dir_plain(*tabs, u_s), iters=5)
    rows_d, rows_10 = shape_rows("env_sample_dir", sample_case)
    entry("env_sample_dir", "envkernels.cu", "envkernels.py:154",
          ok and all_ok(rows_d + rows_10), err, ms, pms,
          roofline("env_sample_dir", (m, eh, ew)), by_shape=rows_d,
          by_shape_path10=rows_10)

    # a direction within an ulp of a texel border may fall in the
    # neighbouring texel: torch divides by a scalar on the card as a
    # multiply by its reciprocal, the kernel (like XLA) divides
    def pdf_check(d):
        pk = ek.env_pdf_dir(sampler.m_pdf, sampler.c_pdf, d)
        pp = ek.env_pdf_dir_plain(sampler.m_pdf, sampler.c_pdf, d)
        return compare(f"env_pdf_dir {tuple(d.shape)}",
                       pk.reshape(-1, 1), pp.reshape(-1, 1), 1e-6, 1e-5,
                       min_frac=0.9999)

    # D′ runs on the generic paths alone (path 5 here): the fused trace's
    # pdf is H's
    dirs = d_lobe.reshape(m, 3).contiguous()
    o, e = pdf_check(dirs)
    ms = dev_ms(lambda: ek.env_pdf_dir(sampler.m_pdf, sampler.c_pdf, dirs))
    pms = cuda_ms(lambda: ek.env_pdf_dir_plain(sampler.m_pdf, sampler.c_pdf,
                                               dirs), iters=5)
    entry("env_pdf_dir", "envkernels.cu", "envkernels.py:317", o, e, ms, pms,
          roofline("env_pdf_dir", (m, eh, ew)), path="path 5")

    # H: a fused bounce's record (D′'s pdf, both bilinear taps, the gates
    # and the casts) in one launch, bit for bit against its plain version
    # (that composition on the card, D′ included) at every main-path and
    # path-10 shape on the inputs the trace chunks gave it, and at the
    # relight's (render_final's 512² passes: 8 × 512² jittered rows,
    # uncompacted), whose bounce 0 is the entry's headline
    def record_check(args, what):
        got = ek.bounce_record(*args)
        want = ek.bounce_record_plain(*args)
        bad = [int((a.view(torch.int16) != b.view(torch.int16)).sum())
               for a, b in zip(got, want)]
        log(f"  bounce_record {what}: aux, recb, nrm halves that differ "
            f"from the plain version's {bad} (allowed 0)")
        return not any(bad), float(sum(bad))

    def record_shape(args):
        """H's launch shape of a call (``_lib.count_launch``'s)."""
        _lib.reset_launches()
        ek.bounce_record(*args)
        (key, _), = _lib.LAUNCHES_BY_SHAPE.items()
        return key[1]

    def record_case(shp, tr):
        call = [c for c in tr.env_calls["bounce_record"]
                if c[2].numel() // 3 == shp[0]]
        if not call:
            fail(f"no recorded bounce_record call of {shp[0]} rows")
        args = call[0]
        return dict(run=lambda: ek.bounce_record(*args),
                    check=lambda: record_check(args, f"{list(shp)}"))

    tr_rl = capture_trace(torch, (cam_p, gbuf_p, mats_p, env),
                          shader.RenderConfig(spp=64, chunk=8,
                                              film_jitter=0.5), g)
    ok_rl = [record_check(c, f"relight bounce {b}")
             for b, c in enumerate(tr_rl.env_calls["bounce_record"])]
    rl = tr_rl.env_calls["bounce_record"][0]
    shp_rl = record_shape(rl)
    ms = dev_ms(lambda: ek.bounce_record(*rl))
    pms = cuda_ms(lambda: ek.bounce_record_plain(*rl), iters=5)
    rows_d, rows_10 = shape_rows("bounce_record", record_case)
    entry("bounce_record", "envkernels.cu", None,
          all(o for o, _ in ok_rl) and len(ok_rl) == 3
          and all_ok(rows_d + rows_10), max(e for _, e in ok_rl), ms, pms,
          roofline("bounce_record", shp_rl), by_shape=rows_d,
          by_shape_path10=rows_10, relight_shape=list(shp_rl),
          jax_function="none (no TPU kernel; replaces the JAX package's "
          "XLA-fused record ops, materialist_tpu/render/shader.py)")

    # P: the jittered primary vertex in one launch, bit for bit against its
    # plain version, on the photo scene's G-buffer and a lattice draw, at
    # the main path's 4 × 512² rows (siren512's) and the relight's 8 × 512²,
    # each with the position (the trace's call) and without (the shade's);
    # the first is the entry's headline
    from materialist_tpu_torch.ops.kernels import primary as pk

    def primary_row(s_p, pos):
        h_p, w_p = gbuf_p.dist.shape
        u = rng.lattice(rng.key(SEED + 2), s_p, h_p * w_p,
                        shader._LATTICE_G[2], dev)
        args = (u, gbuf_p.dist, gbuf_p.normal_geo, gbuf_p.valid, 0, 0.5,
                cam_p)
        got = pk.primary_state(*args, pos)
        want = pk.primary_state_plain(*args)
        bad = [int((a.view(torch.int32) != b.view(torch.int32)).sum()
                   if a.is_floating_point() else (a != b).sum())
               for a, b in zip(got, want) if a is not None]
        shp = (s_p * h_p * w_p, h_p, w_p, int(pos))
        log(f"  primary_state {list(shp)}: elements that differ from the "
            f"plain version's {bad} (allowed 0)")
        ms = dev_ms(lambda: pk.primary_state(*args, pos))
        return dict(shape=list(shp), ok=not any(bad), ms=ms,
                    device_ms=ms.device_ms,
                    plain_ms=cuda_ms(lambda: pk.primary_state_plain(*args),
                                     iters=5),
                    bound_ms=roofline("primary_state", shp)[0])

    rows_p = [primary_row(s_p, pos) for s_p in (4, 8)
              for pos in (True, False)]
    entry("primary_state", "primary.cu", None, all(r["ok"] for r in rows_p),
          0.0, rows_p[0]["ms"], rows_p[0]["plain_ms"],
          roofline("primary_state", rows_p[0]["shape"]), by_shape=rows_p,
          jax_function="none (no TPU kernel; XLA fuses "
          "materialist_tpu/render/shader.py:323)")

    # E: the sky fetch of a chunk, one query per pixel (its only shape on
    # the main path and on path 10)
    def lookup_args(tr):
        u0, v0, du, dv = em.bilinear_coords(-tr.gbuf.wo.reshape(tr.n, 3), 16,
                                            32)
        return (tr.env.contiguous(), u0.to(torch.int32).contiguous(),
                v0.to(torch.int32).contiguous(), du, dv)

    def lookup_check(a):
        lk = ek.env_lookup_bilinear(*a)
        lp = ek.env_lookup_bilinear_plain(*a)
        return compare(f"env_lookup_bilinear {a[1].shape[0]}", lk, lp, 1e-6,
                       1e-6)

    def lookup_case(shp, tr):
        if tuple(shp) != (tr.n, 16, 32):
            fail(f"unexpected shape of the bilinear fetch: {shp}")
        a = lookup_args(tr)
        return dict(run=lambda: ek.env_lookup_bilinear(*a),
                    check=lambda: lookup_check(a))

    rows_e, rows_10 = shape_rows("env_lookup_bilinear", lookup_case)
    a_e = lookup_args(tr_main)
    pms = cuda_ms(lambda: ek.env_lookup_bilinear_plain(*a_e), iters=5)
    entry("env_lookup_bilinear", "envkernels.cu", "envkernels.py:229",
          all_ok(rows_e + rows_10), rows_e[0]["max_abs_err"], rows_e[0]["ms"],
          pms, roofline("env_lookup_bilinear", (n, *envc.shape[:2])),
          by_shape=rows_e, by_shape_path10=rows_10)

    # ---- C: row gather at the continuation pack's shape, (m, 6) rows at
    # the ascending indices of a compaction into cap = 9/16 m, and at
    # random indices; then every shape of the main path's (>= 10% of its
    # launches) and of a path-10 fresh iteration, and path 5's, each in
    # its callers' order; then every route on seeded tables
    cap = 589824
    alive = torch.rand((m,), generator=g, device=dev) < 0.5
    sel, count = rowops.compact_sel(alive, cap)
    table = torch.randn((m, 6), generator=g, device=dev)
    sel_r = torch.randint(0, m, (cap,), generator=g, device=dev,
                          dtype=torch.int32)
    oks, errs, times = [], [], {}
    for tag, ix, exact in (("ascending", sel, True), ("bf16", sel, False),
                           ("random", sel_r, True)):
        got = rowops.row_gather(table, ix, exact=exact, coherent=True)
        o, e = compare(f"row_gather {tag}", got,
                       rowops.row_gather_plain(table, ix, exact), 0.0, 0.0)
        oks.append(o)
        errs.append(e)
        times[tag] = dev_ms(lambda: rowops.row_gather(table, ix,
                                                       exact=exact))
    pms = cuda_ms(lambda: rowops.row_gather_plain(table, sel), iters=5)
    lib_ms = dev_ms(lambda: torch.index_select(table, 0, sel))
    lib_r = dev_ms(lambda: torch.index_select(table, 0, sel_r))
    log(f"  row_gather: ascending {times['ascending']:.4f} ms, bf16 "
        f"{times['bf16']:.4f} ms, random {times['random']:.4f} ms; "
        f"index_select ascending {lib_ms:.4f} ms, random {lib_r:.4f} ms")

    def gather_row(tb, ix, coherent, where, **row):
        """C against its plain version, bitwise, at one shape; its device
        ms back to back (``device_ms``, L2 warm as on a path that wrote
        the table just before) and with L2 emptied before each call
        (``cold_device_ms``), beside ``index_select``'s, the byte bound
        (useful bytes) and the sector bound (the 32-byte sectors the
        card reads, ``utils/profiling.py::gather_sector_bytes``; also
        counted in 64-byte sectors, the bound where device memory is
        read two sectors at a time). The sector bounds are chip_smoke's
        own: the sectors hang on the indices, which the launch shape does
        not carry."""
        n_t, k_t = tb.shape
        m_q = ix.numel()
        shp = (n_t, k_t, m_q, int(coherent))
        o, _ = compare(f"{where}: row_gather {shp}",
                       rowops.row_gather(tb, ix, coherent=coherent),
                       rowops.row_gather_plain(tb, ix), 0.0, 0.0)
        oks.append(o)

        def run():
            rowops.row_gather(tb, ix, coherent=coherent)

        def lib_run():
            torch.index_select(tb, 0, ix)
        t_k, t_l = cuda_ms(run), cuda_ms(lib_run)
        row.setdefault("bound_ms", roofline("row_gather", shp)[0])
        row.update(shape=list(shp), ms=t_k,
                   device_ms=kernel_device_ms(run),
                   cold_device_ms=kernel_device_ms(run, flush=True),
                   library_ms=t_l,
                   library_device_ms=kernel_device_ms(lib_run),
                   library_cold_device_ms=kernel_device_ms(lib_run,
                                                           flush=True),
                   sector_bound_ms=bound(gather_sector_bytes(ix, k_t),
                                         0)[0],
                   sector64_bound_ms=bound(gather_sector_bytes(
                       ix, k_t, sector=64), 0)[0])
        log(f"    {where}: row_gather {shp}"
            + (f" x {row['launches']} launches" if "launches" in row else "")
            + f": device {row['device_ms']} ms, L2 emptied "
            f"{row['cold_device_ms']} ms; index_select "
            f"{row['library_device_ms']}, "
            f"{row['library_cold_device_ms']} ms; bound "
            f"{row['bound_ms']:.4f}, sector bound "
            f"{row['sector_bound_ms']:.4f} ms (64-byte sectors "
            f"{row['sector64_bound_ms']:.4f})")
        return row

    def compaction_idx(tr, n_t, m_q):
        """The recorded chunk's own indices for an ascending gather of m_q
        rows from n_t: a compaction's (its live rays ascending, then its
        padding at 0), or the second compaction's taken through the
        first's (the film indices of the rays that survive both); None
        where the chunk has no such compaction."""
        sels = [(a.numel(), cap, rowops.compact_sel(a, cap)[0])
                for a, cap in tr.sels]
        for n_a, cap, sl in sels:
            if (n_a, cap) == (n_t, m_q):
                return sl
        for (n1, c1, s1), (n2, c2, s2) in zip(sels, sels[1:]):
            if n2 == c1 and (n1, c2) == (n_t, m_q):
                return s1[s2.long()]
        return None

    def gather_rows(shapes, gen, where, tr):
        """Seeded tables at each shape, gathered at sorted seeded indices
        where the callers' indices ascend, at uniform ones where not; an
        ascending shape also at the recorded chunk's own compaction
        indices (``compaction``), whose padding repeats one row."""
        rows = []
        for (n_t, k_t, m_q, coherent), cnt in shapes:
            tb = torch.randn((n_t, k_t), generator=gen, device=dev)
            ix = torch.randint(0, n_t, (m_q,), generator=gen, device=dev,
                               dtype=torch.int32)
            if coherent:
                ix = torch.sort(ix).values
            rows.append(gather_row(tb, ix, coherent, where, launches=cnt))
            ic = compaction_idx(tr, n_t, m_q) if coherent else None
            if ic is not None:
                rows[-1]["compaction"] = gather_row(
                    tb, ic, True, where + ", its compaction's indices")
            del tb, ix, ic
        return rows
    rows_g = gather_rows(shapes_of("row_gather"), g, "main", tr_main)
    # every shape of a path-10 fresh iteration, most launched first
    rows_10 = gather_rows(
        sorted(((shp, v) for (nm, shp), v in bench_info["by_shape"].items()
                if nm == "row_gather"),
               key=lambda r: (-r[1], [-x for x in r[0]])), tr_10.g,
        "path 10", tr_10)
    if any(r.get(c, r)[t] is None for r in rows_10 + rows_g
           for c in ("", "compaction")
           for t in ("device_ms", "cold_device_ms")):
        fail("the profiler saw no device time of a row_gather row")
    fresh_ms = sum(r["launches"] * r["device_ms"] for r in rows_10)
    fresh_cold = sum(r["launches"] * r["cold_device_ms"] for r in rows_10)
    fresh_own = sum(r["launches"] * r.get("compaction", r)["device_ms"]
                    for r in rows_10)
    log(f"  path 10: C's device ms in a fresh iteration {fresh_ms:.4f} "
        f"(L2 emptied before each call {fresh_cold:.4f}; at the chunk's "
        f"own compaction indices where it has them {fresh_own:.4f})")
    tr_10 = None
    torch.cuda.empty_cache()
    # the transparency edit's rows (path 5): the trace's side table of the
    # (N, 15) transparent table, 20 wide, fetched for a chunk of 8 samples
    # a pixel at seeded hit indices. The queries repeat rows, so
    # chip_smoke's own byte bound reads each distinct row of the table
    # once, which the launch shape does not carry.
    k_t = 20
    tb = torch.randn((n, k_t), generator=g, device=dev)
    ix = torch.randint(0, n, (8 * n,), generator=g, device=dev,
                       dtype=torch.int32)
    distinct = int(torch.unique(ix).numel())
    rows_w = [gather_row(tb, ix, False, "path 5", path="path 5",
                         distinct_rows=distinct,
                         bound_ms=bound(8 * n * (4 + 4 * k_t)
                                        + distinct * 4 * k_t, 0)[0])]
    del tb, ix
    # every route: each compiled-in width and the run-time one (15), on a
    # contiguous table, a table[1:] view and a view one float in (the
    # float route of every width), at random indices
    routes = []
    for k_t in (3, 5, 6, 8, 13, 15, 20):
        n_t = 2 ** 20
        base = torch.randn((n_t, k_t), generator=g, device=dev)
        flat = torch.empty(n_t * k_t + 1, device=dev)
        flat[1:] = base.reshape(-1)
        up = torch.cat([base[:1], base])
        ix = torch.randint(0, n_t, (2 ** 20 + 3,), generator=g, device=dev,
                           dtype=torch.int32)
        for view, tb in (("contiguous", base), ("row_view", up[1:]),
                         ("float_offset", flat[1:].view(n_t, k_t))):
            for exact in (True, False):
                o, _ = compare(f"row_gather route {k_t} {view} exact={exact}",
                               rowops.row_gather(tb, ix, exact=exact),
                               rowops.row_gather_plain(tb, ix, exact), 0.0,
                               0.0)
                oks.append(o)
                routes.append(dict(k=k_t, view=view, exact=exact, ok=o))
        del base, flat, up
    torch.cuda.empty_cache()
    entry("row_gather", "rowops.cu", "rowops.py:89", all(oks), max(errs),
          times["ascending"], pms, roofline("row_gather", (m, 6, cap, 1)),
          library_ms=lib_ms, by_shape=rows_g, by_shape_path10=rows_10,
          path10_fresh_device_ms=fresh_ms,
          path10_fresh_cold_device_ms=fresh_cold,
          path10_fresh_own_indices_device_ms=fresh_own, wide_rows=rows_w,
          routes=routes, ms_bf16=times["bf16"],
          ms_random=times["random"], library_ms_random=lib_r,
          device_ms_random=times["random"].device_ms,
          library_device_ms_random=lib_r.device_ms)

    # ---- A′: the single march, full and shadow_only, on the seeded map
    skw = dict(n_steps=cfg.march_steps, fine_steps=cfg.fine_steps,
               interval_frac=cfg.march_interval_frac)
    oks, t_errs, times = [], [], {}
    for shadow_only in (False, True):
        hk = mk.march_single(cam_a, tab, origin, d_lobe,
                             shadow_only=shadow_only, **skw)
        hp = ss.march_mip(cam_a, tab.dist, tab.valid, tab.mip, origin,
                          d_lobe, mip_factor=tab.mip_f, fine_table=tab.fine,
                          fine_factor=tab.fine_f, shadow_only=shadow_only,
                          **skw)
        agree = {nm: float((a == b).float().mean()) for nm, a, b in (
            ("hit", hk.hit, hp.hit), ("idx", hk.idx, hp.idx))}
        both = hk.hit & hp.hit & (hk.idx == hp.idx)
        t_errs.append(float((hk.t - hp.t).abs()[both].max()))
        frac = float(hp.hit.float().mean())
        log(f"  march_single shadow_only={shadow_only}: flags agree {agree} "
            f"(>= 0.999), hit fraction {frac:.3f}, t max_abs_err "
            f"{t_errs[-1]:.3e} where both hit")
        oks.append(all(v >= 0.999 for v in agree.values())
                   and (shadow_only or 0.01 < frac < 0.99))
        times[shadow_only] = dev_ms(lambda: mk.march_single(
            cam_a, tab, origin, d_lobe, shadow_only=shadow_only, **skw))
    pms = cuda_ms(lambda: ss.march_mip(
        cam_a, tab.dist, tab.valid, tab.mip, origin, d_lobe,
        mip_factor=tab.mip_f, fine_table=tab.fine, fine_factor=tab.fine_f,
        **skw), iters=3, warmup=1)
    # the entry's time is the full march's: its bound, chip_smoke's own as
    # march_pair's, counts the steps these rays need, one direction in,
    # hit/idx/t out, the origin's stored rows (a broadcast over the
    # samples) and the tables
    steps = needed_march_steps(torch, cam_a, tab, origin, d_lobe,
                               cfg.march_steps, cfg.fine_steps, False)
    steps_so = needed_march_steps(torch, cam_a, tab, origin, d_lobe,
                                  cfg.march_steps, cfg.fine_steps, True)
    full = m * (cfg.march_steps + 2 * cfg.fine_steps)
    log(f"    march_single steps needed {steps} of {full} (shadow_only: "
        f"{steps_so} of {m * cfg.march_steps})")
    entry("march_single", "march_pair.cu", "march_kernel.py:250", all(oks),
          max(t_errs), times[False], pms,
          bound(m * (12 + 9) + 12 * mk._origin_rows(origin).shape[0]
                + 4 * (tab.mip.numel() + tab.fine.numel()),
                steps * FLOPS_PER_MARCH_STEP), path="nee_false",
          ms_shadow_only=times[True], steps_needed=steps, steps_full=full,
          steps_needed_shadow_only=steps_so)

    # ---- F, G: lookups from the 128x128 mip and the 256x256 fine table
    # of the "mip" march at 512x512 (F: m lookups, one march step of a
    # chunk; G: 2 m lookups)
    mip_tab = shader.march_tables(cfg._replace(march_impl="mip"), gbuf_a)
    for name, fn, plain, n_q, src_line, path in (
            ("onehot_gather", gather.onehot_gather,
             gather.onehot_gather_plain, m, "gather.py:72", "mip"),
            ("vreg_gather", vreg.vreg_gather, vreg.vreg_gather_plain, 2 * m,
             "vreg_gather.py:65", "standalone")):
        oks, times, libs, plains = [], {}, {}, {}
        for tb in (mip_tab.mip, mip_tab.fine):
            ix = torch.randint(0, tb.numel(), (n_q,), generator=g,
                               device=dev, dtype=torch.int32)
            flat = tb.reshape(-1)
            o, _ = compare(f"{name} {tuple(tb.shape)}", fn(tb, ix),
                           plain(tb, ix), 0.0, 0.0)
            oks.append(o)
            times[tb.shape[0]] = dev_ms(lambda: fn(tb, ix))
            plains[tb.shape[0]] = cuda_ms(lambda: plain(tb, ix), iters=5)
            libs[tb.shape[0]] = dev_ms(
                lambda: torch.index_select(flat, 0, ix))
        log(f"  {name}: {n_q} lookups, 128x128 table {times[128]:.4f} ms "
            f"(index_select {libs[128]:.4f}), 256x256 table "
            f"{times[256]:.4f} ms (index_select {libs[256]:.4f})")
        # chip_smoke's own bound: the wrappers count F's and G's launches
        # without a shape, so the roofline has none
        entry(name, "gathers.cu", src_line, all(oks), 0.0, times[128],
              plains[128], bound(n_q * 8 + 128 * 128 * 4, 0),
              library_ms=libs[128],
              path=path, ms_256=times[256], library_ms_256=libs[256],
              device_ms_256=times[256].device_ms,
              library_device_ms_256=libs[256].device_ms)

    # ---- the draws (threefry_draw; it replaces no TPU kernel: the JAX
    # package draws through XLA's threefry): each mode bit for bit against
    # its int64 plain version on the card, keys from split and fold_in;
    # the lattice at the 1024² bench's streams (8 samples over 1 or 2
    # dims), the 512² relight's and ragged sizes, the uniforms at the
    # i.i.d. branch's stream, the bits at the device trainer's batch, and
    # randint and bernoulli against the CPU's
    k_d = rng.fold_in(rng.split(rng.key(SEED + 5), 3)[2], 991)

    def same_bits(got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            return False
        if got.is_floating_point():
            got, want = got.view(torch.int32), want.view(torch.int32)
        return torch.equal(got, want)

    def draw_row(what, run, plain, ok, shape):
        hashed, samples = shape[:2]   # of the counted launch shape
        row = dict(what=what, hashed=hashed, samples=samples, ok=ok)
        if hashed >= 2 ** 18:
            row.update(ms=dev_ms(run), plain_ms=cuda_ms(plain, iters=5))
            row["device_ms"] = row["ms"].device_ms
            row["bound_ms"] = roofline("threefry_draw", shape)[0]
            log(f"  threefry_draw {what}: kernel {row['ms']:.4f} ms "
                f"(device {row['device_ms']}), plain {row['plain_ms']:.4f} "
                f"ms, bound {row['bound_ms']:.4f} ms")
        if not ok:
            log(f"  threefry_draw {what}: differs from its plain version")
        return row

    lat_rows = []
    for s_d, n_d, dims in ((8, BENCH_RES ** 2, 2), (8, BENCH_RES ** 2, 1),
                           (8, 512 * 512, 2), (8, 512 * 512, 1),
                           (8, 1023, 1), (3, 1025, 2), (1, 1, 2)):
        gens = shader._LATTICE_G[dims]
        lat_rows.append(draw_row(
            f"lattice ({s_d}, {n_d}, {dims})",
            lambda: rng.lattice(k_d, s_d, n_d, gens, dev),
            lambda: rng.lattice_plain(k_d, s_d, n_d, gens, dev),
            same_bits(rng.lattice(k_d, s_d, n_d, gens, dev),
                      rng.lattice_plain(k_d, s_d, n_d, gens, dev)),
            (n_d * dims, s_d, 4, 2)))
    uni_rows, bit_rows = [], []
    for shp in ((8, BENCH_RES ** 2, 2), (8, 512 * 512, 2), (1023,), (3, 7),
                (1025, 3)):
        uni_rows.append(draw_row(
            f"uniform {shp}", lambda: rng.uniform(k_d, shp, dev),
            lambda: rng.uniform_plain(k_d, shp, dev),
            same_bits(rng.uniform(k_d, shp, dev),
                      rng.uniform_plain(k_d, shp, dev)),
            (math.prod(shp), 1, 4, 1)))
        bit_rows.append(draw_row(
            f"bits {shp}", lambda: rng.bits(k_d, shp, dev),
            lambda: rng.bits_plain(k_d, shp, dev),
            same_bits(rng.bits(k_d, shp, dev), rng.bits_plain(k_d, shp, dev)),
            (math.prod(shp), 1, 8, 0)))
    k_t = rng.split(rng.key(SEED + 6))[1]
    host_ok = (torch.equal(rng.randint(k_t, (4,), 0, 64, dev).cpu(),
                           rng.randint(k_t, (4,), 0, 64))
               and torch.equal(rng.bernoulli(k_t, 0.5, (4,), dev).cpu(),
                               rng.bernoulli(k_t, 0.5, (4,))))
    bit_rows.append(dict(what="randint, bernoulli (4,) card vs CPU",
                         ok=host_ok))
    # each mode's launches are its own (draw_launches): the lattice's on
    # the main path, the uniforms' (bernoulli) and the bits' (randint) in
    # path 8c's device trainer
    for what, rows, nbytes, path in (("lattice", lat_rows, 4, "main"),
                                     ("uniform", uni_rows, 4, "path 8c"),
                                     ("bits", bit_rows, 8, "path 8c")):
        top = rows[0]
        entry(f"threefry_draw {what}", "threefry.cu", None, all_ok(rows),
              0.0, top["ms"], top["plain_ms"],
              roofline("threefry_draw", (top["hashed"], top["samples"],
                                         nbytes, DRAW_MODES.index(what))),
              path=path,
              counter=f"threefry_draw {what}", rows=rows)
    return out


# --------------------------------------------------------------- main path

def _scene_inputs(d):
    from materialist_tpu_torch.io import exr as exr_io
    br = os.path.join(d, "best_results")
    return {
        "albedo": exr_io.read(os.path.join(br, "albedo.exr"))[..., :3],
        "roughness": exr_io.read(os.path.join(br, "roughness.exr"))[..., :1],
        "metallic": exr_io.read(os.path.join(br, "metallic.exr"))[..., :1],
        "normal": exr_io.read(os.path.join(br, "normal.exr"))[..., :3],
        "gt_image": exr_io.read(os.path.join(d, "gt_image.exr"))[..., :3],
    }, exr_io.read(os.path.join(d, "depthPred.exr"))[..., 0]


def _optimize_run(torch, _lib, compact, num_epochs, n_rows):
    """One ``optimize`` run on a fresh copy of the scene; returns (best,
    launches, wall seconds, peak bytes, launches by shape)."""
    from materialist_tpu_torch.camera import Camera
    from materialist_tpu_torch.opt.loop import InverseOptions, optimize
    from materialist_tpu_torch.render.scene import make_gbuffer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_opt_")
    try:
        d = os.path.join(tmp, "photo_e2e")
        shutil.copytree(os.path.join(REPO, "output_imgs", "runs",
                                     "photo_e2e"), d)
        os.remove(os.path.join(d, "metrics.jsonl"))  # the fixture's own log
        mat, depth = _scene_inputs(d)
        cam = Camera(512, 512)
        gbuf = make_gbuffer(depth, cam, flip_depth=True, device="cuda")
        opts = InverseOptions(opt_src="a", opt_order=("rm", "a"),
                              max_loops=2, num_epochs=num_epochs,
                              frame_every=0, snapshot_every=0,
                              compact=compact)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        best = optimize(gbuf, cam, mat, d, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_lib.LAUNCHES)
        by_shape = dict(_lib.LAUNCHES_BY_SHAPE)
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows = [json.loads(x) for x in f]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  wall {wall:.2f} s, peak memory {peak / 2**30:.2f} GiB")
    losses = [(r["phase"], r["epoch"], r["loss"], r["mse"]) for r in rows]
    log(f"  losses (phase, epoch, loss, mse): {losses}")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["mse"])
               for r in rows):
        fail("non-finite loss")
    phases = {r["phase"] for r in rows}
    if phases != {"env", "mat_mlp[rm]"} or len(rows) != n_rows:
        fail(f"unexpected phase schedule {sorted(phases)} ({len(rows)})")
    img = best["rendered_img"]
    if tuple(img.shape) != (512, 512, 3) or not bool(
            torch.isfinite(img).all()):
        fail("rendered image is not a finite 512x512x3 image")
    log(f"  launches: {launches}")
    return best, launches, wall, peak, by_shape


def main_path(torch, _lib):
    """Path 1 between two runs of the same without compaction at a
    smaller depth. The first run of a process also pays its set-up (CUDA
    context, allocator growth), so the compacted run is held against the
    uncompacted run after it."""
    runs = []
    for label, compact, epochs, rows in (
            ("[uncompacted, first] compact=False: env -> rm -> env",
             False, 1, 3),
            ("[main path] wavefront compaction at probed caps: env -> rm x3 "
             "-> env x3", True, 3, 7),
            ("[uncompacted, again] compact=False: env -> rm -> env",
             False, 1, 3)):
        log(label + ", optimize at 512x512x64spp")
        runs.append(_optimize_run(torch, _lib, compact, epochs, rows))
    (best_0, _, wall_0, peak_0, _), (best, launches, wall, peak, by_shape), \
        (best_u, _, wall_u, peak_u, _) = runs
    caps, util = best["compact_caps"], best["cap_util"]
    log(f"  probed compact_caps {caps}, cap_util per bounce {util}")
    if len(caps) != 2 or sorted(util) != [1, 2]:
        fail("the main path did not run compacted")
    if any(u >= 0.999 for u in util.values()):
        fail(f"a compaction cap saturated: {util}")
    if launches["row_gather"] <= 0:
        fail("row_gather was not launched on the main path")
    for b in (best_0, best_u):
        if b["compact_caps"] != () or b["cap_util"]:
            fail("compact=False still compacted")
    log("  phase, ms per call: uncompacted first | compacted | "
        "uncompacted again")
    for name in ("env_trace", "env_step", "mat_trace[rm]", "mat_mlp[rm]"):
        ms = [b["timer"][name] / b["timer_counts"][name] * 1e3
              for b in (best_0, best, best_u)]
        log(f"  {name}: {ms[0]:.1f} | {ms[1]:.1f} | {ms[2]:.1f}")
    log(f"  peak memory GiB: {peak_0 / 2**30:.2f} | {peak / 2**30:.2f} | "
        f"{peak_u / 2**30:.2f}")
    log(f"  wall s (steps): {wall_0:.2f} (3) | {wall:.2f} (7) | "
        f"{wall_u:.2f} (3)")
    return launches, by_shape, caps


def _drive(torch, _lib, fn):
    """Run ``fn`` with the launch counters set to 0 just before and read
    just after; returns (result, launches, seconds)."""
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(_lib.LAUNCHES), time.perf_counter() - t0


def nee_false_path(torch, _lib):
    """Path 2: a 512x512 render without NEE (generic shade, single march)
    and its gradients."""
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.render.scene import Materials
    from materialist_tpu_torch.render.shader import RenderConfig, render

    log("[path 2] render 512x512x8spp with nee=False, and its gradients")
    cam, gbuf, mats, env = photo_scene(torch, torch.device(DEV))
    leaves = [t.clone().requires_grad_() for t in
              (mats.albedo, mats.roughness, mats.metallic, env)]
    cfg = RenderConfig(nee=False, spp=8, chunk=4, film_jitter=0.5)

    def run():
        img = render(rng.key(SEED + 5), cfg, cam, gbuf,
                     Materials(*leaves[:3], mats.normal), leaves[3])
        torch.mean(img ** 2).backward()
        return img.detach()

    img, launches, sec = _drive(torch, _lib, run)
    log(f"  {sec:.2f} s, image mean {float(img.mean()):.4f}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if tuple(img.shape) != (512, 512, 3) or not bool(
            torch.isfinite(img).all()):
        fail("nee=False render is not a finite 512x512x3 image")
    for nm, leaf in zip(("albedo", "roughness", "metallic", "envmap"),
                        leaves):
        if leaf.grad is None or not bool(torch.isfinite(leaf.grad).all()) \
                or float(leaf.grad.abs().max()) == 0.0:
            fail(f"nee=False render: no finite non-zero gradient for {nm}")
    if launches["march_single"] <= 0 or launches["march_pair"] != 0:
        fail("nee=False render did not go through march_single")
    return launches


def mip_path(torch, _lib):
    """Path 3: one envmap step and one rm step of make_phase_step with
    march_impl="mip" (march_mip over the table-lookup kernel)."""
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.io import exr as exr_io
    from materialist_tpu_torch.ops.color import linear_to_srgb
    from materialist_tpu_torch.opt import schedules
    from materialist_tpu_torch.opt.step import make_phase_step
    from materialist_tpu_torch.render.scene import Materials
    from materialist_tpu_torch.render.shader import RenderConfig

    log("[path 3] one env step and one rm step at 512x512x8spp, "
        "march_impl='mip'")
    dev = torch.device(DEV)
    cam, gbuf, mats, env = photo_scene(torch, dev)
    gt = linear_to_srgb(torch.as_tensor(exr_io.read(os.path.join(
        REPO, "output_imgs", "runs", "photo_e2e", "gt_image.exr"))[..., :3],
        dtype=torch.float32, device=dev))
    cfg = RenderConfig(spp=8, chunk=4, film_jitter=0.5, march_impl="mip")

    def loss_of(maps, img, extra):
        return torch.mean((linear_to_srgb(img) - gt) ** 2), None

    def env_maps(p, extra):
        return extra, p["envmap"]

    def rm_maps(p, extra):
        return Materials(mats.albedo, torch.clamp(p["roughness"], 0.07, 1),
                         torch.clamp(p["metallic"], 0, 1), mats.normal), extra

    cases = (("env", env_maps, {"envmap": env.clone().requires_grad_()},
              mats),
             ("rm", rm_maps,
              {"roughness": mats.roughness.clone().requires_grad_(),
               "metallic": mats.metallic.clone().requires_grad_()}, env))

    def run():
        out = []
        for i, (name, maps_of, params, extra) in enumerate(cases):
            phase = make_phase_step(cfg, cam, gbuf, maps_of, loss_of)
            opt = schedules.adam_plain(1e-3)
            state = opt.init(list(params.values()))
            recs = phase.trace_all(params, extra, rng.key(SEED + 6 + i))
            before = {k: v.detach().clone() for k, v in params.items()}
            loss, _, _ = phase.make_step(opt)(params, state, extra, recs)
            moved = max(float((params[k].detach() - before[k]).abs().max())
                        for k in params)
            out.append((name, float(loss), moved))
        return out

    res, launches, sec = _drive(torch, _lib, run)
    log(f"  {sec:.2f} s, (phase, loss, largest update): {res}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    for name, loss, moved in res:
        if not math.isfinite(loss) or not 0.0 < moved < 1.0:
            fail(f"'mip' {name} step: loss {loss}, update {moved}")
    if launches["onehot_gather"] <= 0 or launches["march_pair"] != 0:
        fail("the 'mip' steps did not go through onehot_gather")
    return launches


def standalone_lookup(torch, _lib):
    """Kernel G has no caller in the package: it reads the scene's mip
    (128x128) and fine (256x256) tables at the cells the first coarse step
    of a chunk's lobe march visits, and must equal kernel F there."""
    from materialist_tpu_torch.ops.kernels.gather import onehot_gather
    from materialist_tpu_torch.ops.kernels.vreg_gather import vreg_gather
    from materialist_tpu_torch.render import shader

    log("[standalone] vreg_gather on the scene's mip and fine tables")
    dev = torch.device(DEV)
    cam, gbuf, _, _ = photo_scene(torch, dev)
    cfg = shader.RenderConfig(march_impl="mip")
    tab = shader.march_tables(cfg, gbuf)
    q = gbuf.position.reshape(-1, 3) + tab.t_lo * gbuf.normal_geo.reshape(
        -1, 3)
    uv = cam.project(q.repeat(4, 1))
    ui = torch.floor(uv[..., 0] + 0.5).to(torch.int32).clamp(0, 511)
    vi = torch.floor(uv[..., 1] + 0.5).to(torch.int32).clamp(0, 511)

    def run():
        out = []
        for tb, f in ((tab.mip, tab.mip_f), (tab.fine, tab.fine_f)):
            ix = ((vi // f) * tb.shape[1] + ui // f).contiguous()
            out.append((tb, ix, vreg_gather(tb, ix)))
        return out

    res, launches, _ = _drive(torch, _lib, run)
    for tb, ix, got in res:
        if not bool(torch.equal(got, onehot_gather(tb, ix))) or not bool(
                torch.equal(got, tb.reshape(-1)[ix.long()])):
            fail(f"vreg_gather disagrees on the {tuple(tb.shape)} table")
    log(f"  {res[0][1].numel()} lookups per table, equal to onehot_gather "
        f"and to indexing; launches {launches['vreg_gather']}")
    return launches


def _small_scene(torch):
    res = 64
    g = torch.Generator().manual_seed(SEED)
    depth = 2.0 + torch.rand((res, res), generator=g)
    depth[16:40, 10:30] -= 0.8
    alb = 0.2 + 0.7 * torch.rand((res, res, 3), generator=g)
    rough = 0.2 + 0.7 * torch.rand((res, res, 1), generator=g)
    met = 0.5 * torch.rand((res, res, 1), generator=g)
    env = (torch.rand((16, 32, 3), generator=g) + 0.1) * 2
    return res, depth, (alb, rough, met, env)


def _render_and_grads(torch, cfg, dev, res, depth, maps):
    """[image, d_albedo, d_roughness, d_metallic, d_envmap] on the CPU."""
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.camera import Camera
    from materialist_tpu_torch.ops.color import linear_to_srgb
    from materialist_tpu_torch.render.scene import Materials, make_gbuffer
    from materialist_tpu_torch.render.shader import render
    cam = Camera(res, res)
    gb = make_gbuffer(depth, cam, flip_depth=False, device=dev)
    leaves = [x.to(dev).requires_grad_() for x in maps]
    mats = Materials(leaves[0], leaves[1], leaves[2], gb.normal_geo)
    img = render(rng.key(3), cfg, cam, gb, mats, leaves[3])
    torch.mean(linear_to_srgb(img) ** 2).backward()
    return [img.detach().cpu()] + [x.grad.cpu() for x in leaves]


NAMES = ("image", "d_albedo", "d_roughness", "d_metallic", "d_envmap")


def compaction_agreement(torch):
    """64x64 scene rendered and differentiated on the card from one key
    with compact_caps=() and (1.0, 1.0): the compacted estimator is the
    uncompacted one up to the order of the film sums. Limits: image rtol
    1e-4 / atol 1e-5, albedo and envmap gradients within 2e-3 of their
    maximum (the JAX package's own, tests/test_compact.py)."""
    from materialist_tpu_torch.render.shader import RenderConfig
    log("[agreement] 64x64x8spp on the card, compact_caps=() vs (1.0, 1.0)")
    res, depth, maps = _small_scene(torch)
    base = RenderConfig(spp=8, chunk=4, max_depth=4, film_jitter=0.5)
    ref = _render_and_grads(torch, base, "cuda", res, depth, maps)
    got = _render_and_grads(torch, base._replace(compact_caps=(1.0, 1.0)),
                            "cuda", res, depth, maps)
    for nm, a, b in zip(NAMES, got, ref):
        err = (a - b).abs()
        scale = float(b.abs().max())
        log(f"  {nm}: max_abs_err/max {float(err.max()) / scale:.3e}")
        if nm == "image":
            ok = bool((err <= 1e-5 + 1e-4 * b.abs()).all())
        else:
            ok = float(err.max()) <= 2e-3 * scale
        if not ok or not bool(torch.isfinite(a).all()):
            fail(f"compacted and uncompacted renders disagree on {nm}")


def small_agreement(torch, march_impl="fused"):
    """64² scene rendered and differentiated on the card and on the CPU
    from the same keys: the kernels against the plain versions end to
    end."""
    from materialist_tpu_torch.render.shader import RenderConfig

    log(f"[agreement] 64x64x8spp render + gradients, card vs CPU, "
        f"march_impl={march_impl!r}")
    res, depth, maps = _small_scene(torch)
    cfg = RenderConfig(spp=8, chunk=4, max_depth=4, film_jitter=0.5,
                       march_impl=march_impl)
    res_out = {dev: _render_and_grads(torch, cfg, dev, res, depth, maps)
               for dev in ("cuda", "cpu")}
    for nm, a, b in zip(NAMES, res_out["cuda"], res_out["cpu"]):
        scale = float(b.abs().max())
        err = (a - b).abs()
        mean_rel = float(err.mean() / b.abs().mean().clamp_min(1e-12))
        log(f"  {nm}: max_abs_err/max {float(err.max()) / scale:.3e}, "
            f"mean rel {mean_rel:.3e}")
        if not bool(torch.isfinite(a).all()) or mean_rel > 2e-2 or \
                float(err.max()) > 0.2 * scale:
            fail(f"card and CPU disagree on {nm}")


# ------------------------------------------------------- the forward path

def _forward_scene(root):
    """A copy of the photo_e2e scene under ``root`` with what the forward
    CLIs read besides: a rectangular mask.png, bg.png made from
    gt_image.exr, and in front of the heightfield oi.ply (a sphere, the
    glass insert) and oi2.ply (a quad, the diffuse insert). Returns the
    mask as a bool array."""
    import numpy as np
    from materialist_tpu_torch.geometry.ply import write_ply
    from materialist_tpu_torch.io import exr as exr_io
    from materialist_tpu_torch.io import image as image_io
    from materialist_tpu_torch.utils import seeded
    d = os.path.join(root, "photo_e2e")
    shutil.copytree(os.path.join(REPO, "output_imgs", "runs", "photo_e2e"), d)
    br = os.path.join(d, "best_results")
    mask = np.zeros((512, 512), bool)
    mask[160:352, 192:320] = True
    image_io.write(os.path.join(br, "mask.png"),
                   np.repeat(mask[..., None].astype(np.float32), 3, -1),
                   linear_input=False)
    image_io.write(os.path.join(br, "bg.png"), exr_io.read(
        os.path.join(d, "gt_image.exr"))[..., :3])
    depth = exr_io.read(os.path.join(d, "depthPred.exr"))[..., 0]
    near = float((2 * depth.max() - depth).min())     # the flipped depth
    z = 0.6 * near
    write_ply(os.path.join(d, "oi.ply"),
              *seeded.sphere_mesh([0.06 * z, 0.0, -z], 0.09 * z, 24, 48))
    write_ply(os.path.join(d, "oi2.ply"),
              *seeded.quad_mesh([-0.22 * z, -0.2 * z, -1.1 * z],
                                [0.14 * z, 0, 0.04 * z],
                                [0, 0.12 * z, 0.04 * z]))
    return mask


def _finite_image(torch, img, what):
    import numpy as np
    if tuple(img.shape) != (512, 512, 3) or not np.isfinite(img).all() \
            or not float(img.mean()) > 0.0:
        fail(f"{what}: not a finite non-black 512x512x3 image")


def _need_files(d, names, what):
    for f in names:
        if not os.path.exists(os.path.join(d, f)):
            fail(f"{what} did not write {f}")


def forward_paths(torch, _lib):
    """Paths 4 to 6 on a temporary copy of the scene, through the CLIs'
    entry functions at their defaults' width (512x512): relight, material
    edit and rolling envmap (path 4), the transparency edit (path 5) and
    object insertion (path 6). Returns {path: launches}."""
    import numpy as np
    from materialist_tpu_torch import config as gconfig
    from materialist_tpu_torch.cli import mat_edit, render_final, trans_edit
    from materialist_tpu_torch.io import image as image_io
    from materialist_tpu_torch.render import forward

    def counters(launches, want, what):
        log(f"  launches {what}: { {k: v for k, v in launches.items() if v} }")
        for k in want:
            if launches[k] <= 0:
                fail(f"{what}: kernel {k} was not launched")
        for k in NO_GRAD_NONE_OF:
            if launches[k] != 0:
                fail(f"{what}: {k} was launched {launches[k]} times on a "
                     "path that takes no gradient and does not compact")

    times = {"render": [], "denoise": []}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def ms(name):
        v = times[name]
        return (f"{sum(v) / len(v):.1f} ms mean, {min(v):.1f} least, over "
                f"{len(v)}")

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fwd_")
    render, denoise = forward.render_with_bsdf, forward.atrous_denoise
    out_dir_was = gconfig.OUT_DIR
    try:
        mask = _forward_scene(tmp)
        d = os.path.join(tmp, "photo_e2e")
        gconfig.OUT_DIR = tmp
        forward.render_with_bsdf = timed("render", render)
        forward.atrous_denoise = timed("denoise", denoise)
        kw = dict(input_path=tmp, save_path=tmp)

        log("[path 4] relight: render_final real at the CLI's defaults "
            "(512x512, 64 spp x 10 passes, denoised, the scene's 16x32 "
            "envmap); mat_edit (hue shift + roughness, 2 passes); rolling "
            "(3 frames, 32 spp)")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def path4():
            real = render_final.render_real("photo_e2e", **kw)
            t_real = {k: list(v) for k, v in times.items()}
            mat_edit.main(["--save_name", "photo_e2e", "--hue_shift", "0.3",
                           "0.1", "0.0", "--roughness", "0.4", "--n_iter",
                           "2", "--input_path", tmp, "--save_path", tmp])
            edited = image_io.read(os.path.join(
                d, "mi_photo_e2e_envmap__a_0.3_r_0.4.exr"))[..., :3]
            render_final.render_rolling("photo_e2e", frames=3,
                                        rotation_step=30.0, **kw)
            return real, edited, t_real
        (real, edited, t_real), launches, sec = _drive(torch, _lib, path4)
        peak = torch.cuda.max_memory_allocated()
        _finite_image(torch, real, "render_real")
        _finite_image(torch, edited, "mat_edit")
        _need_files(d, ("mi_photo_e2e_envmap_.exr", "mi_photo_e2e_envmap_.png",
                        "mi_photo_e2e_envmap__a_0.3_r_0.4.exr",
                        "rolling_envmap_animation/frame_0002.png",
                        "rolling_envmap_photo_e2e_envmap.gif"), "path 4")
        moved = float(np.abs(edited[mask] - real[mask]).mean())
        if not moved > 1e-3:
            fail(f"the material edit did not change the masked region "
                 f"({moved})")
        times.update(t_real)
        log(f"  {sec:.2f} s; per 64-spp pass of render_real: render "
            f"{ms('render')}; denoise {ms('denoise')}; peak memory "
            f"{peak / 2**30:.2f} GiB; edit moved the masked pixels by "
            f"{moved:.4f}")
        counters(launches, ("march_pair", "shade_bounce_fwd", "row_gather",
                            "env_sample_dir", "bounce_record",
                            "env_lookup_bilinear"), "path 4")
        out["path 4"] = launches

        log("[path 5] transparency edit: ior 1.2, specTrans 0.4, 512x512, "
            "64 spp x 2 passes, generic shade")
        times["render"], times["denoise"] = [], []
        torch.cuda.reset_peak_memory_stats()
        img, launches, sec = _drive(
            torch, _lib, lambda: trans_edit.transparency_edit(
                "photo_e2e", 1.2, False, 0.4, n_iter=2, save_path=tmp))
        peak = torch.cuda.max_memory_allocated()
        _finite_image(torch, img, "trans_edit")
        stem = "mi_trans_1.2_woA_0.4_photo_e2e_envmap"
        _need_files(d, (f"{stem}.exr", f"{stem}.png"), "path 5")
        moved = float(np.abs(img[mask] - real[mask]).mean())
        if not moved > 1e-3:
            fail("the transparency edit did not change the masked region")
        log(f"  {sec:.2f} s; per 64-spp pass: render {ms('render')}; peak "
            f"memory {peak / 2**30:.2f} GiB")
        counters(launches, ("march_pair", "row_gather", "env_sample_dir",
                            "env_pdf_dir", "env_lookup_bilinear"), "path 5")
        # the trace fetches the (N, 15) transparent table inside its side
        # table of 20 and the shade pass reuses those rows, so every gather
        # of this path is 20 wide, at the shape the kernels phase timed
        wide = {tuple(shp): c for (nm, shp), c
                in _lib.LAUNCHES_BY_SHAPE.items() if nm == "row_gather"}
        log(f"  row_gather shapes: {wide}")
        if wide.get((512 * 512, 20, 8 * 512 * 512, 0), 0) \
                != launches["row_gather"]:
            fail(f"path 5 fetched other rows than the transparent side "
                 f"table's: {wide}")
        if launches["shade_bounce_fwd"] or launches["bounce_record"]:
            fail("the transparency edit took the fused shade")
        out["path 5"] = launches

        log("[path 6] object insertion: render_final oi, 512x512, 32 spp x 2 "
            "passes, a diffuse quad and a glass sphere")
        times["render"], times["denoise"] = [], []
        torch.cuda.reset_peak_memory_stats()
        img, launches, sec = _drive(
            torch, _lib, lambda: render_final.render_io("photo_e2e", n_iter=2,
                                                        **kw))
        peak = torch.cuda.max_memory_allocated()
        _finite_image(torch, img, "render_io")
        _need_files(d, ("mi_oi_photo_e2e_envmap.exr",
                        "mi_oi_photo_e2e_envmap.png"), "path 6")
        from materialist_tpu_torch.camera import Camera
        from materialist_tpu_torch.geometry.ply import read_ply
        from materialist_tpu_torch.geometry.raster import rasterize
        for name in ("oi.ply", "oi2.ply"):
            cover = rasterize(*read_ply(os.path.join(d, name)),
                              Camera(512, 512))[2]
            moved = float(np.abs(img[cover] - real[cover]).mean())
            log(f"  {name}: covers {int(cover.sum())} pixels, moved them by "
                f"{moved:.4f}")
            if cover.sum() < 500 or not moved > 1e-2:
                fail(f"the insert {name} does not show in the image")
        log(f"  {sec:.2f} s; per 32-spp pass: render {ms('render')}; peak "
            f"memory {peak / 2**30:.2f} GiB")
        counters(launches, ("march_pair", "shade_bounce_fwd", "row_gather",
                            "env_sample_dir", "bounce_record",
                            "env_lookup_bilinear"), "path 6")
        out["path 6"] = launches
    finally:
        forward.render_with_bsdf, forward.atrous_denoise = render, denoise
        gconfig.OUT_DIR = out_dir_was
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def forward_agreements(torch):
    """The forward path's pieces on the card against the same calls on the
    CPU from the same keys, on the seeded 64x64 scene with a sphere in
    front of it: an averaged denoised render and a transparent render
    (mean relative error <= 2e-2, as the other 64x64 agreements),
    shade_glass (within 1e-4 but for at most 0.1% of the glass pixels,
    whose march may flip at a silhouette), and the "exact" march on the
    seeded rays of the march tests (hit flags equal on >= 0.999)."""
    import numpy as np
    from materialist_tpu_torch.camera import Camera
    from materialist_tpu_torch.geometry.raster import rasterize
    from materialist_tpu_torch.render import bsdf as bsdf_mod
    from materialist_tpu_torch.render import forward, glass
    from materialist_tpu_torch.render import screenspace as ss
    from materialist_tpu_torch.render.scene import Materials, make_gbuffer
    from materialist_tpu_torch.utils import seeded

    log("[agreement] forward path, 64x64, card vs CPU")
    res, depth, (alb, rough, met, env) = _small_scene(torch)
    cam = Camera(res, res)
    verts, faces = seeded.sphere_mesh([0.05, 0.0, -1.2], 0.25, 24, 48)
    fd, fn, cover = rasterize(verts, faces, cam, layer="front")
    bd, bn, _ = rasterize(verts, faces, cam, layer="back")
    g = torch.Generator().manual_seed(SEED + 1)
    bg = torch.rand((res, res, 3), generator=g)
    mask = torch.zeros((res, res), dtype=torch.bool)
    mask[16:48, 20:44] = True
    got = {}
    for dev in ("cuda", "cpu"):
        gb = make_gbuffer(depth, cam, flip_depth=False, device=dev)
        mats = Materials(alb.to(dev), rough.to(dev), met.to(dev),
                         gb.normal_geo)
        trans = bsdf_mod.transparent(mats, bg.to(dev), mask.to(dev), 0.4, 1.2,
                                     cam, gb.position.reshape(-1, 3))
        gmask = cover & (fd < gb.dist.cpu().numpy())
        got[dev] = dict(
            averaged=forward.render_averaged(gb, cam, mats, env, n_iter=2,
                                             spp=8, seed=3),
            transparent=forward.render_averaged(gb, cam, mats, env, n_iter=2,
                                                spp=8, seed=3, denoise=False,
                                                bsdf=trans),
            glass=glass.shade_glass(cam, gb.dist, gb.valid, bg, env, fd, fn,
                                    bd, bn, gmask).cpu().numpy())
    for nm in ("averaged", "transparent"):
        a, b = got["cuda"][nm], got["cpu"][nm]
        mean_rel = float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12))
        log(f"  {nm} render: mean rel {mean_rel:.3e} (allowed 2e-2), "
            f"max_abs_err/max {float(np.abs(a - b).max() / b.max()):.3e}")
        if not np.isfinite(a).all() or mean_rel > 2e-2:
            fail(f"card and CPU disagree on the {nm} render")
    a, b = got["cuda"]["glass"], got["cpu"]["glass"]
    off = np.any(np.abs(a - b) > 1e-4, -1)[gmask]
    log(f"  shade_glass: {int(gmask.sum())} glass pixels, {int(off.sum())} "
        "beyond 1e-4 (allowed 0.1%)")
    if gmask.sum() < 200 or off.mean() > 1e-3 or not np.isfinite(a).all():
        fail("card and CPU disagree on shade_glass")

    for case, shadow_only in seeded.MARCH_CASES:
        cam_m, tab, o, d, _, _ = seeded.march_case_inputs(case, shadow_only)
        o, d = torch.from_numpy(o), torch.from_numpy(d)
        for vec in (False, True):
            kw = dict(n_steps=24, n_refine=5, interval_frac=0.05,
                      vectorized=vec)
            hc = ss.march(cam_m, tab.dist, tab.valid, o, d, **kw)
            hk = ss.march(cam_m, tab.dist.cuda(), tab.valid.cuda(), o.cuda(),
                          d.cuda(), **kw)
            agree = float((hk.hit.cpu() == hc.hit).float().mean())
            both = hk.hit.cpu() & hc.hit
            t_err = float((hk.t.cpu() - hc.t)[both].abs().max()) \
                if both.any() else 0.0
            log(f"  exact march {case}, vectorized={vec}: hit flags agree "
                f"{agree:.4f} (>= 0.999), {int(both.sum())} hits, t "
                f"max_abs_err {t_err:.3e}")
            if agree < 0.999 or t_err > 1e-4:
                fail(f"card and CPU disagree on the exact march ({case})")


def cli_run():
    log("[cli] inverse --opt_src skip --opt_order skip --num_epochs 2")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        d = os.path.join(tmp, "photo_e2e")
        shutil.copytree(os.path.join(REPO, "output_imgs", "runs",
                                     "photo_e2e"), d)
        t0 = time.time()
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        p = subprocess.run(
            [sys.executable, "-m", "materialist_tpu_torch.cli.inverse",
             "--img_inverse_path", os.path.join(d, "gt_image.exr"),
             "--save_name", d, "--opt_src", "skip", "--opt_order", "skip",
             "--num_epochs", "2", "--frame_every", "0"], cwd=REPO, env=env,
            capture_output=True, text=True)
        LOG.extend(p.stdout.splitlines()[-20:])
        if p.returncode:
            LOG.extend(p.stderr.splitlines()[-40:])
            fail(f"CLI exited {p.returncode}")
        log(f"  cli {time.time() - t0:.1f} s")
        br = os.path.join(d, "best_results")
        want = [os.path.join(br, f) for f in (
            "albedo.exr", "roughness.exr", "metallic.exr", "normal.exr",
            "rendered_img.exr", "envmap.hdr")] + [
            os.path.join(d, "final_envmap.hdr")]
        for f in want:
            if not os.path.exists(f) or os.path.getmtime(f) < t0:
                fail(f"CLI did not write {f}")
        log("  best_results layout written")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ path 7

MATNET_CKPT = os.path.join(REPO, "runs", "matnet_r5", "matnet_scratch.npz")
PHOTO_E2E = os.path.join(REPO, "output_imgs", "runs", "photo_e2e")
PATH7_KERNELS = ("march_pair", "shade_bounce_fwd", "shade_bounce_bwd",
                 "row_gather", "row_scatter_add", "row_scatter_add_bf16",
                 "row_scatter_add_coherent", "compact_sel", "env_sample_dir",
                 "bounce_record", "env_lookup_bilinear")


def matnet_flops(torch, net, x):
    """Operations of one forward of ``net`` on ``x``, counted from the
    shapes the forward sees: dense layers, convolutions (transposed ones
    included) and attention (QKᵀ and PV, 4·B·N²·C). Elementwise work
    (norms, GELU, softmax, resizes) is left out: under 1% of the sum."""
    from torch import nn
    from materialist_tpu_torch.models.dinov2 import Attention
    tot = {"dense": 0, "attention": 0, "conv": 0}

    def hook(m, inp, out):
        a = inp[0]
        if isinstance(m, nn.Linear):
            tot["dense"] += 2 * a.numel() * m.out_features
        elif isinstance(m, nn.Conv2d):
            tot["conv"] += 2 * m.weight[0].numel() * out.numel()
        elif isinstance(m, nn.ConvTranspose2d):
            tot["conv"] += 2 * a.numel() * m.weight[0].numel()
        else:
            b, n, c = a.shape
            tot["attention"] += 4 * b * n * n * c

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d,
                               Attention))]
    try:
        with torch.inference_mode():
            net(x)
    finally:
        for h in hooks:
            h.remove()
    return tot


def _top_kernels(torch, fn, iters=3, n=6):
    """``fn`` once, then ``iters`` times under ``torch.profiler``: (device
    ms per call or None, device operations per call, and the ``n``
    kernels with the most device time as (name, device ms per call,
    launches per call))."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = sorted(_device_events(prof), key=lambda ev: -ev.device_time_total)
    total_us = sum(ev.device_time_total for ev in evs)
    top = [(ev.key[:60], round(ev.device_time_total / iters / 1e3, 4),
            ev.count // iters) for ev in evs[:n]]
    return (total_us / iters / 1e3 if total_us > 0 else None,
            sum(ev.count for ev in evs) / iters, top)


@contextlib.contextmanager
def tf32_defaults(torch):
    """PyTorch's own TF32 flags, as a process that does not set them runs
    (the CLI: cuDNN's convolutions in TF32, matmuls in FP32); TF32 off
    again on exit."""
    torch.backends.cuda.matmul.allow_tf32 = TF32_DEFAULTS["matmul"]
    torch.backends.cudnn.allow_tf32 = TF32_DEFAULTS["cudnn"]
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _forward_numbers(torch, net, x, what, iters):
    """ms per forward (CUDA events, profiler device ms), peak memory and
    the bound of ``net`` on ``x`` on the card at the TF32 flags in force;
    logged and returned. The operations bound takes the convolutions at
    the TF32 peak where cuDNN may use TF32, the dense layers and the
    attention where matmuls may, else at the FP32 peak."""
    conv_tf32 = torch.backends.cudnn.allow_tf32
    mm_tf32 = torch.backends.cuda.matmul.allow_tf32
    what += (f" (TF32: convolutions {'on' if conv_tf32 else 'off'}, "
             f"matmuls {'on' if mm_tf32 else 'off'})")
    flops = matnet_flops(torch, net, x)
    n_bytes = 4 * (sum(p.numel() for p in net.parameters()) + x.numel())
    with torch.inference_mode():
        out = net(x)
        n_bytes += 4 * sum(v.numel() for v in out.values())
        del out
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        net(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        t = cuda_ms(lambda: net(x), iters=iters, device=True)
        _, _, top = _top_kernels(torch, lambda: net(x))
    ops_ms = 1e3 * (
        flops["conv"] / (H100_TF32_FLOPS if conv_tf32 else PEAK_FP32_PER_S)
        + (flops["dense"] + flops["attention"])
        / (H100_TF32_FLOPS if mm_tf32 else PEAK_FP32_PER_S))
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    b_ms, b_by = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                  else (ops_ms, "operations"))
    dev = f"{t.device_ms:.3f}" if t.device_ms else "not measured"
    log(f"  {what}: {t:.3f} ms per forward (events), device {dev} ms; "
        f"bound {b_ms:.3f} ms ({b_by}: "
        f"{sum(flops.values()) / 1e9:.2f} GFLOP = dense "
        f"{flops['dense'] / 1e9:.2f} + attention "
        f"{flops['attention'] / 1e9:.2f} + conv {flops['conv'] / 1e9:.2f}; "
        f"{n_bytes / 1e6:.1f} MB); peak memory {peak / 2**30:.3f} GiB "
        f"(weights and input {base / 2**30:.3f} GiB)")
    log(f"  {what}, device ms per forward of the heaviest kernels: {top}")
    return {"ms": float(t), "device_ms": t.device_ms, "bound_ms": b_ms,
            "gflop": sum(flops.values()) / 1e9, "peak_gib": peak / 2**30}


def _map_errors(got, ref, what, max_abs):
    for k in ref:
        if got[k].shape != ref[k].shape:
            fail(f"{what}: {k} has shape {got[k].shape}, not "
                 f"{ref[k].shape}")
    errs = {k: float(abs(got[k] - ref[k]).max()) for k in ref}
    log(f"  {what}: max_abs_err {errs} (allowed {max_abs})")
    if any(not e <= max_abs for e in errs.values()):
        fail(f"{what}: disagree beyond {max_abs}")


def _against_recorded(maps, what):
    """The maps against the predictions the JAX package recorded on a TPU
    (bf16 passes): mean abs albedo <= 2e-3, normal <= 8e-3, max abs depth
    <= 1e-2."""
    import numpy as np
    from materialist_tpu_torch.io import exr as exr_io
    rec = {n: exr_io.read(os.path.join(PHOTO_E2E, f"{n}Pred.exr"))
           for n in ("albedo", "normal", "depth")}
    alb = float(np.abs(maps["albedo"][..., :3] - rec["albedo"][..., :3]).mean())
    nrm = float(np.abs(maps["normal"][..., :3] - rec["normal"][..., :3]).mean())
    depth = maps["depth"] if maps["depth"].ndim == 2 else maps["depth"][..., 0]
    dep = float(np.abs(depth - rec["depth"][..., 0]).max())
    log(f"  {what} against the recorded TPU predictions: mean abs albedo "
        f"{alb:.3e} (<= 2e-3), normal {nrm:.3e} (<= 8e-3); max abs depth "
        f"{dep:.3e} (<= 1e-2)")
    if not (alb <= 2e-3 and nrm <= 8e-3 and dep <= 1e-2):
        fail(f"{what} disagree with the recorded predictions")


def predict_path(torch, _lib):
    """Path 7, predict from a photo: (a) MaterialNet from the in-repo
    checkpoint on photo_e2e's gt_image.exr, card against CPU and against
    the recorded predictions, timed at 518²; (b) the full vit-b width with
    seeded weights at 518², card against CPU at 70²; both timed with TF32
    off and at PyTorch's default flags; (c) the inverse CLI's ``main``
    with photo_e2e's predict flags, in this process at PyTorch's default
    TF32 flags (seconds, launch counts, files). Returns the launches of
    (c)."""
    x = torch.rand((1, 3, 518, 518), generator=torch.Generator().manual_seed(
        SEED)).to(DEV)
    predict_checkpoint(torch, x)
    predict_vitb(torch, x)
    return predict_cli(torch, _lib)


def predict_checkpoint(torch, x):
    import numpy as np
    from materialist_tpu_torch.io import exr as exr_io
    from materialist_tpu_torch.models.matnet import MatNetInference
    photo = exr_io.read(os.path.join(PHOTO_E2E, "gt_image.exr"))[..., :3]
    log("[path 7a] MaterialNet, in-repo checkpoint, photo_e2e at 518x518")
    t0 = time.perf_counter()
    card = MatNetInference(weights_path=MATNET_CKPT)
    log(f"  load {time.perf_counter() - t0:.2f} s")
    got = card.infer_image(photo)
    cpu = MatNetInference(weights_path=MATNET_CKPT,
                          device="cpu").infer_image(photo)
    for k, v in got.items():
        if not np.isfinite(v).all():
            fail(f"path 7a: {k} is not finite")
    _map_errors(got, cpu, "card vs CPU", 1e-3)
    _against_recorded(got, "card maps")
    _forward_numbers(torch, card.net, x, "checkpoint forward at 518x518", 20)
    with tf32_defaults(torch):
        _forward_numbers(torch, card.net, x, "checkpoint forward at 518x518",
                         20)


def predict_vitb(torch, x):
    import copy
    from materialist_tpu_torch.models.dpt import MaterialNet
    log("[path 7b] MaterialNet vit-b (embed 768, 12 layers, 12 heads, "
        "features 128), seeded weights")
    net_cpu = MaterialNet(generator=torch.Generator().manual_seed(SEED))
    net_cpu.eval()
    net = copy.deepcopy(net_cpu).to(DEV)
    with torch.inference_mode():
        out = {k: v.float() for k, v in net(x).items()}
    for k, v in out.items():
        if tuple(v.shape[-2:]) != (518, 518) or not bool(
                torch.isfinite(v).all()):
            fail(f"vit-b {k} is not a finite 518x518 map")
    n_err = float((torch.linalg.vector_norm(out["normal"], dim=1) - 1)
                  .abs().max())
    low = min(float(out[k].min()) for k in ("depth", "albedo", "roughness",
                                           "metallic"))
    log(f"  518x518: normals unit within {n_err:.2e} (<= 1e-3), least of "
        f"depth/albedo/roughness/metallic {low:.3e} (>= 0), largest "
        f"{ {k: round(float(v.max()), 4) for k, v in out.items()} }")
    if n_err > 1e-3 or low < 0:
        fail("vit-b maps out of their ranges")
    del out
    x70 = torch.rand((1, 3, 70, 70), generator=torch.Generator().manual_seed(
        SEED + 1))
    with torch.inference_mode():
        a = {k: v.cpu().numpy() for k, v in net(x70.to(DEV)).items()}
        b = {k: v.numpy() for k, v in net_cpu(x70).items()}
    _map_errors(a, b, "vit-b at 70x70 (pos-embed interpolated), card vs CPU",
                1e-3)
    _forward_numbers(torch, net, x, "vit-b forward at 518x518", 10)
    with tf32_defaults(torch):
        _forward_numbers(torch, net, x, "vit-b forward at 518x518", 10)


def predict_cli(torch, _lib):
    from materialist_tpu_torch.cli import inverse
    from materialist_tpu_torch.io import exr as exr_io
    argv = ["--opt_src", "a", "--opt_order", "rm", "a", "--opt_env_from",
            "2", "--weights", MATNET_CKPT, "--num_epochs", "2",
            "--frame_every", "0"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_predict_")
    try:
        img = os.path.join(tmp, "gt_image.exr")
        shutil.copy(os.path.join(PHOTO_E2E, "gt_image.exr"), img)
        d = os.path.join(tmp, "photo_pred")
        log("[path 7c] inverse CLI main(), predict branch, in this process "
            "at PyTorch's default TF32 flags: " + " ".join(argv[:8]))
        with tf32_defaults(torch):
            _, launches, sec = _drive(torch, _lib, lambda: inverse.main(
                ["--img_inverse_path", img, "--save_name", d] + argv))
        log(f"  main() {sec:.2f} s; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        for k in PATH7_KERNELS:
            if launches[k] <= 0:
                fail(f"path 7: kernel {k} was not launched after the "
                     "prediction")
        _need_files(d, ("albedoPred.exr", "normalPred.exr",
                        "roughnessPred.png", "metallicPred.png",
                        "depthPred.exr", "gt_image.exr", "gt_image.png",
                        "config.json", "final_envmap.hdr"), "predict CLI")
        # an absolute --save_name puts the mesh beside the output dir
        _need_files(tmp, ("photo_pred.ply",), "predict CLI")
        _need_files(os.path.join(d, "best_results"), (
            "albedo.exr", "roughness.exr", "metallic.exr", "normal.exr",
            "rendered_img.exr", "envmap.hdr"), "predict CLI")
        with open(os.path.join(d, "config.json")) as f:
            cfg = json.load(f)
        if cfg["opt_src"] != "a" or cfg["opt_order"] != ["rm", "a"] \
                or cfg["opt_env_from"] != 2:
            fail(f"predict CLI wrote config {cfg}")
        _against_recorded({n: exr_io.read(os.path.join(d, f"{n}Pred.exr"))
                           for n in ("albedo", "normal", "depth")},
                          "CLI maps (PyTorch's default TF32)")
        log("  prediction files, config.json, PLY and best_results written")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ------------------------------------------------------------ path 8

PATH8_KERNELS = ("march_pair", "shade_bounce_fwd", "row_gather",
                 "env_sample_dir", "bounce_record", "env_lookup_bilinear")
PATH8_TUPLES, PATH8_SPP, PATH8_STEPS, PATH8_BATCH = 64, 32, 300, 4
REPEAT_STEPS = 30          # path 8c's bit-for-bit repeat of the first steps
# path 8b's bounds on the trainable gradients, each tensor's largest
# difference over its largest value: card against CPU, and each device
# against the gradient computed in float64 on the CPU. Float32 steps have
# read 0.7-1.7e-3 on an H100 (a last-bit change of the forward moves the
# reading), the card's step with cuDNN's TF32 on 0.10 (PERF.md §6, PR 8)
GRAD_CARD_CPU, GRAD_EXACT = 4e-3, 4e-3


def train_path(torch, _lib):
    """Path 8, MaterialNet training: (a) the device trainer's
    ``render_dataset`` (64 tuples at 224x336, 32 spp, on the card; A, B,
    C, D, H and E must launch, B′, C′ and ``compact_sel`` must not); (b)
    one step of the frozen recipe of the reduced net, card against CPU;
    (c) the device trainer's step for 300 steps, timed; (d) its f16
    checkpoint through ``MatNetInference``; (e) ``generate`` and ``train``
    on disk at the vit-b width. Returns the launches of (a), of
    ``generate`` and (``draw_launches``) of (c)'s draws."""
    from materialist_tpu_torch.cli import train_matnet_device as tdev
    log(f"[path 8a] render_dataset: {PATH8_TUPLES} tuples at "
        f"{tdev.IM_HW[0]}x{tdev.IM_HW[1]}, {PATH8_SPP} spp, on the card")
    data, launches, sec = _drive(torch, _lib, lambda: tdev.render_dataset(
        PATH8_TUPLES, PATH8_SPP, SEED))
    _path8_counters(launches, PATH8_KERNELS, "render_dataset")
    if not bool(torch.isfinite(data["im"]).all()) or not float(
            data["im"].mean()) > 0:
        fail("path 8: rendered images not finite or black")
    log(f"  {sec:.2f} s, {sec / PATH8_TUPLES * 1e3:.1f} ms per tuple; "
        f"image mean {float(data['im'].mean()):.4f}")
    frozen_step_card_vs_cpu(torch, data)
    net, draws = scratch_on_card(torch, data)
    checkpoint_roundtrip(torch, net)
    return launches, disk_route(torch, _lib), draws


def _path8_counters(launches, want, what):
    log(f"  launches {what}: { {k: v for k, v in launches.items() if v} }")
    for k in want:
        if launches[k] <= 0:
            fail(f"path 8, {what}: kernel {k} was not launched")
    for k in NO_GRAD_NONE_OF:
        if launches[k] != 0:
            fail(f"path 8, {what}: {k} was launched {launches[k]} times")


def frozen_step_card_vs_cpu(torch, data):
    """One frozen-recipe step (lr 1e-4) of the reduced net (the heads'
    last biases lifted) on the first two tuples (depth in scene units, as
    MGDataset gives it), TF32 off,
    from the same weights on the card and on the CPU: loss terms within
    1e-4 relative; the trainable gradients card against CPU within
    ``GRAD_CARD_CPU`` of each tensor's largest, and each device's within
    ``GRAD_EXACT`` of the gradient computed in float64 on the CPU (in
    the depth head's last convolutions a float32 step lies 1-2e-3 from
    the exact gradient, and a last-bit change of the forward moves that
    reading); a control, the
    card's step with cuDNN's TF32 on, must fail both bounds; each
    device's parameters equal to AdamW's first step on its own gradient
    (1e-7), and card and CPU within 1e-5 where the difference of the
    gradients pins the step (2·lr elsewhere, counted); a seeded LPIPS
    forward within 1e-4 relative."""
    import copy
    from materialist_tpu_torch.cli import train_matnet_device as tdev
    from materialist_tpu_torch.models import lpips
    from materialist_tpu_torch.models import train as tr
    log("[path 8b] frozen-recipe step of the reduced net, batch 2, card "
        "against CPU (TF32 off)")
    batch = {k: v[:2].cpu() for k, v in data.items()}
    batch["depth"] = batch["depth"] * 1e-3
    net = tdev.reduced_net(SEED, "cpu")
    with torch.no_grad():
        # seeded heads put depth at its ReLU and the loss's clamp, where a
        # last-bit difference flips a gradient: lift their last biases
        net.depth_head.scratch.output_conv2[2].bias += 1.0
        net.material_head.scratch.output_conv2[2].bias += 0.3
    out = {}
    for run, dev, conv_tf32 in (("cpu", "cpu", False), (DEV, DEV, False),
                                ("control", DEV, True)):
        m = copy.deepcopy(net).to(dev)
        step = tr.make_train_step(m, tr.make_optimizer(m, 1e-4))
        torch.backends.cudnn.allow_tf32 = conv_tf32
        t0 = time.perf_counter()
        try:
            losses = step({k: v.to(dev) for k, v in batch.items()})
        finally:
            torch.backends.cudnn.allow_tf32 = False
        out[run] = ({k: float(v) for k, v in losses.items()}, m,
                    time.perf_counter() - t0)
    (lc, mc, tc), (lg, mg, tg) = out["cpu"], out[DEV]
    loss_err = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12) for k in lc)
    pc, pg = dict(mc.named_parameters()), dict(mg.named_parameters())
    train = tr.trainable_names(mc)
    m64 = copy.deepcopy(net).double()
    tr.make_optimizer(m64, 1e-4)              # the frozen set's grad flags
    b64 = {k: v.double() for k, v in batch.items()}
    tr.matnet_losses(m64(b64["im"]), b64)["total"].backward()

    def gap(m, ref):
        """The trainable gradients of ``m`` against those of ``ref``:
        the largest difference over the tensor's largest value."""
        r = dict(ref.named_parameters())
        return max(float((p.grad.cpu().double() - r[k].grad.double())
                         .abs().max())
                   / max(float(r[k].grad.abs().max()), 1e-30)
                   for k, p in m.named_parameters() if k in train)
    grad_err, cpu_exact, card_exact = gap(mg, mc), gap(mc, m64), gap(mg, m64)
    ctrl_err, ctrl_exact = gap(out["control"][1], mc), gap(out["control"][1],
                                                          m64)
    # AdamW's first step moves a parameter by lr·g/(|g| + eps) (and the
    # decay lr·wd·p): about ±lr wherever |g| >> eps, whatever |g| is. So
    # each device's step is held to that formula on its own gradient, and
    # across devices the parameters must agree within 1e-5 where the
    # tensor's gradient difference δ pins the step: |g| > 2δ fixes the
    # sign and g² > 10·eps·δ bounds the difference of the two steps,
    # lr·eps·δ/g², by 0.1·lr. Elsewhere they differ by at most 2·lr.
    lr, wd = 1e-4, 0.01
    p0 = net.state_dict()
    sg = mg.state_dict()
    step_err, par_err, n_free, free_err = 0.0, 0.0, 0, 0.0
    for k, v in mc.state_dict().items():
        d = (sg[k].cpu() - v).abs()
        if k in train:
            for p1, gr in ((v, pc[k].grad), (sg[k].cpu(), pg[k].grad.cpu())):
                want = p0[k] * (1 - lr * wd) - lr * gr / (gr.abs() + tr.EPS)
                step_err = max(step_err, float((p1 - want).abs().max()))
            g = pc[k].grad.abs()
            delta = float((pg[k].grad.cpu() - pc[k].grad).abs().max())
            free = (g <= 2 * delta) | (g * g <= 10 * tr.EPS * delta)
            n_free += int(free.sum())
            if free.any():
                free_err = max(free_err, float(d[free].max()))
            d = d[~free]
        par_err = max(par_err, float(d.max()) if d.numel() else 0.0)
    n_train = sum(pc[k].numel() for k in train)
    frozen_same = all(torch.equal(sg[k].cpu(), v)
                      for k, v in net.state_dict().items() if k not in train)
    log(f"  losses {lg}; loss terms rel err {loss_err:.2e} (<= 1e-4), "
        f"trainable grads card against CPU {grad_err:.2e} of their max "
        f"(<= {GRAD_CARD_CPU:g}), against the float64 gradient: CPU "
        f"{cpu_exact:.2e}, card {card_exact:.2e} (<= {GRAD_EXACT:g} each); "
        f"control, the card's step with cuDNN's TF32 on: {ctrl_err:.2e} "
        f"against the CPU, {ctrl_exact:.2e} against float64 (must exceed "
        f"both bounds); each device's step against AdamW's first step on its own gradient "
        f"{step_err:.2e} (<= 1e-7); params card vs CPU {par_err:.2e} "
        f"(<= 1e-5) where the gradient pins the step, {n_free} of "
        f"{n_train} trained elements that it does not pin differ by up to "
        f"{free_err:.2e} (<= 2·lr); frozen unchanged {frozen_same}; step "
        f"s: CPU {tc:.2f}, card {tg:.2f}")
    if not (loss_err <= 1e-4 and grad_err <= GRAD_CARD_CPU
            and max(cpu_exact, card_exact) <= GRAD_EXACT and step_err <= 1e-7
            and par_err <= 1e-5 and free_err <= 2.2e-4 and frozen_same):
        fail("path 8: frozen step card against CPU disagrees")
    if not (ctrl_err > GRAD_CARD_CPU and ctrl_exact > GRAD_EXACT):
        fail("path 8: the gradient bounds pass the TF32 control step")
    g = torch.Generator().manual_seed(SEED)
    lp = lpips.LPIPS()
    with torch.no_grad():
        for name, p in lp.named_parameters():
            if name.endswith("bias") or name.startswith("lin"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g) + 0.02)
        x, y = data["im"][:2].clamp(0, 1), data["albedo"][:2]
        ref = lp(x.cpu(), y.cpu(), normalize=True)
        got = copy.deepcopy(lp).to(DEV)(x, y, normalize=True)
    lp_err = float(((got.cpu() - ref).abs() / ref.abs()).max())
    log(f"  seeded LPIPS at {tdev.IM_HW}: {ref.tolist()}, card rel err "
        f"{lp_err:.2e} (<= 1e-4)")
    if not lp_err <= 1e-4:
        fail("path 8: LPIPS card against CPU disagrees")


def _step_loop(torch, step, n, key):
    """``n`` device-trainer steps, each between two CUDA events; returns
    (losses (n, 6) on the host, ms per step, next key)."""
    from materialist_tpu_torch import rng
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    losses = []
    for s, e in ev:
        key, k = rng.split(key)
        s.record()
        losses.append(torch.stack(list(step(k).values())))
        e.record()
    torch.cuda.synchronize()
    return (torch.stack(losses).cpu(), [s.elapsed_time(e) for s, e in ev],
            key)


def _median(v):
    v = sorted(v)
    return 0.5 * (v[(len(v) - 1) // 2] + v[len(v) // 2])


def scratch_on_card(torch, data):
    """The device trainer's step (the from-scratch recipe, batch 4) for
    300 steps on the rendered tuples at PyTorch's default TF32 flags (the
    trainer's precision): losses finite, the mean of the last 30 under 0.7
    of the first 10's. Timed per step with CUDA events, and again on a
    copy at TF32 off; the profiler's device ms per step, peak memory and
    the operations bound. Then the first 30 steps again, from a fresh net
    of the same seed at the default flags (``repeat_first_steps``): their
    losses and the parameters after them must equal the first run's bit
    for bit. Returns the trained net and the draws' launches by mode
    (``draw_launches``) in the first 30 steps."""
    import copy
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.cli import train_matnet_device as tdev
    from materialist_tpu_torch.models import train as tr
    from materialist_tpu_torch.ops.kernels import _lib
    log(f"[path 8c] device trainer step, batch {PATH8_BATCH}, "
        f"{PATH8_STEPS} steps on the {PATH8_TUPLES} tuples")
    net = tdev.reduced_net(SEED, DEV)
    x = data["im"][:PATH8_BATCH]
    flops = matnet_flops(torch, net, x)
    fwd = sum(flops.values())
    out = {}
    for label, flags in (("default flags", True), ("TF32 off", False)):
        m = net if flags else copy.deepcopy(net)
        n = PATH8_STEPS if flags else 40
        step = tdev.make_device_step(tr.scratch_step(m, 3e-4, PATH8_STEPS),
                                     data, PATH8_BATCH)
        ctx = tf32_defaults(torch) if flags else contextlib.nullcontext()
        with ctx:
            conv_tf32 = torch.backends.cudnn.allow_tf32
            mm_tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = draw_launches(_lib.LAUNCHES_BY_SHAPE)
            losses, ms, key = _step_loop(torch, step, REPEAT_STEPS,
                                         rng.key(SEED + 1))
            if flags:
                run1 = (losses, {k: v.clone()
                                 for k, v in m.state_dict().items()})
                draws = {k: v - before[k] for k, v in
                         draw_launches(_lib.LAUNCHES_BY_SHAPE).items()}
                log(f"  draws in the first {REPEAT_STEPS} steps: {draws}")
            more, ms_more, key = _step_loop(torch, step, n - REPEAT_STEPS,
                                            key)
            losses, ms = torch.cat([losses, more]), ms + ms_more
            peak = torch.cuda.max_memory_allocated()
            dev_ms, n_ops, top = _top_kernels(
                torch, lambda: step(rng.fold_in(key, 0)), iters=5, n=5)
        ops_ms = 3e3 * (
            flops["conv"] / (H100_TF32_FLOPS if conv_tf32 else PEAK_FP32_PER_S)
            + (flops["dense"] + flops["attention"])
            / (H100_TF32_FLOPS if mm_tf32 else PEAK_FP32_PER_S))
        med = _median(ms[20:])
        dev = f"{dev_ms:.3f}" if dev_ms else "not measured"
        log(f"  {label} (TF32: convolutions {'on' if conv_tf32 else 'off'}, "
            f"matmuls {'on' if mm_tf32 else 'off'}): {med:.3f} ms per step "
            f"(events, median of steps 21-{n}), device {dev} ms per step "
            f"(profiler, 5 steps); bound {ops_ms:.3f} ms (operations: 3 x "
            f"{fwd / 1e9:.2f} GFLOP forward = dense "
            f"{flops['dense'] / 1e9:.2f} + attention "
            f"{flops['attention'] / 1e9:.2f} + conv "
            f"{flops['conv'] / 1e9:.2f}); peak memory {peak / 2**30:.3f} GiB "
            f"(the {PATH8_TUPLES} tuples included)")
        log(f"  {label}: {n_ops:.0f} device operations per step; heaviest "
            f"(name, device ms per step, launches per step): {top}")
        out[label] = losses[:, 0]
    total = out["default flags"]
    first, last = float(total[:10].mean()), float(total[-30:].mean())
    at = (0, PATH8_STEPS // 3, 2 * PATH8_STEPS // 3, PATH8_STEPS - 1)
    log(f"  total loss: first 10 mean {first:.4f}, last 30 mean {last:.4f} "
        f"(< 0.7 x first); at steps {at}: "
        f"{[round(float(total[i]), 4) for i in at]}")
    repeats = repeat_first_steps(torch, data, *run1)
    if not (bool(torch.isfinite(total).all())
            and bool(torch.isfinite(out['TF32 off']).all())):
        fail("path 8: a training loss is not finite")
    if not last < 0.7 * first:
        fail("path 8: the scratch recipe's loss did not fall below 0.7x")
    if not repeats:
        fail(f"path 8: the first {REPEAT_STEPS} steps from the same seed "
             "did not repeat bit for bit")
    return net, draws


def repeat_first_steps(torch, data, losses, params):
    """The device trainer's first ``REPEAT_STEPS`` steps again at the
    default flags, from a fresh reduced net of seed ``SEED`` and the keys
    of ``rng.key(SEED + 1)`` on the same data; whether their (steps, 6)
    losses equal ``losses`` and the parameters after them ``params``, bit
    for bit (logged with the run's time)."""
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.cli import train_matnet_device as tdev
    from materialist_tpu_torch.models import train as tr
    net = tdev.reduced_net(SEED, DEV)
    step = tdev.make_device_step(tr.scratch_step(net, 3e-4, PATH8_STEPS),
                                 data, PATH8_BATCH)
    t0 = time.perf_counter()
    with tf32_defaults(torch):
        again, ms, _ = _step_loop(torch, step, REPEAT_STEPS,
                                  rng.key(SEED + 1))
    sec = time.perf_counter() - t0
    same_losses = bool(torch.equal(again, losses))
    now = net.state_dict()
    differ = [k for k, v in params.items() if not torch.equal(now[k], v)]
    log(f"  repeat of the first {REPEAT_STEPS} steps from a fresh net of "
        f"seed {SEED}: {sec:.2f} s, {_median(ms):.3f} ms per step (events, "
        f"median); losses (all six terms) equal bit for bit: {same_losses}; "
        f"parameters after step {REPEAT_STEPS} equal bit for bit: "
        f"{len(params) - len(differ)} of {len(params)} tensors")
    log(f"  first run, total loss at steps 0-{REPEAT_STEPS - 1}: "
        f"{[float(v) for v in losses[:, 0]]}")
    log(f"  repeat,    total loss at steps 0-{REPEAT_STEPS - 1}: "
        f"{[float(v) for v in again[:, 0]]}")
    if not same_losses:
        d = (again - losses).abs()
        log(f"  first differing step {int((d > 0).any(1).nonzero()[0])}, "
            f"largest loss difference {float(d.max()):.3e}")
    if differ:
        log(f"  differing parameters (first 5): {differ[:5]}")
    return same_losses and not differ


def repeat_scratch(torch, n, seeds):
    """Path 8c's training run at PyTorch's default TF32 flags, ``n`` times
    from the seed-0 net, data and keys, then once from each of ``seeds``
    (net and keys; the same data): each run's loss at steps 0, 100, 200,
    299, the ratio of the last 30 to the first 10 (path 8c fails at 0.7),
    each loss term's mean over the last 30, and whether its losses (all
    six terms) equal the first run's bit for bit; fails if a run of seed
    ``SEED`` does not. The data are rendered twice, to show whether they
    repeat bit for bit."""
    import warnings
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.cli import train_matnet_device as tdev
    from materialist_tpu_torch.models import train as tr
    log(f"[path 8c repeated] {n} runs at seed {SEED}, then seeds {seeds}")
    data = tdev.render_dataset(PATH8_TUPLES, PATH8_SPP, SEED)
    again = tdev.render_dataset(PATH8_TUPLES, PATH8_SPP, SEED)
    same = {k: bool(torch.equal(v, again[k])) for k, v in data.items()}
    log(f"  the data rendered twice, equal bit for bit per key: {same}")
    del again
    at = (0, PATH8_STEPS // 3, 2 * PATH8_STEPS // 3, PATH8_STEPS - 1)
    rows, first_run, seen = [], None, set()
    for seed in [SEED] * n + list(seeds):
        net = tdev.reduced_net(seed, DEV)
        step = tdev.make_device_step(tr.scratch_step(net, 3e-4, PATH8_STEPS),
                                     data, PATH8_BATCH)
        names = []

        def named(k, step=step):
            out = step(k)
            names[:] = list(out)
            return out
        t0 = time.perf_counter()
        with tf32_defaults(torch), warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            losses, _, _ = _step_loop(torch, named, PATH8_STEPS,
                                      rng.key(seed + 1))
        seen.update(str(x.message).split("\n")[0][:160] for x in w)
        total = losses[:, 0]
        if seed == SEED and first_run is None:
            first_run = losses
        ratio = float(total[-30:].mean()) / float(total[:10].mean())
        row = dict(seed=seed, ratio=round(ratio, 4),
                   at=[round(float(total[i]), 4) for i in at],
                   last30={nm: round(float(v), 4) for nm, v in
                           zip(names, losses[-30:].mean(0))},
                   finite=bool(torch.isfinite(total).all()),
                   equal_to_first=(seed == SEED
                                   and bool(torch.equal(losses, first_run))),
                   s=round(time.perf_counter() - t0, 1))
        rows.append(row)
        log("  " + json.dumps(row))
    ratios = [r["ratio"] for r in rows if r["seed"] == SEED]
    log(f"  seed {SEED}: ratios {ratios}; over 0.7: "
        f"{sum(r >= 0.7 for r in ratios)} of {len(ratios)}")
    log(f"  warnings of the runs: {sorted(seen)}")
    if not all(r["equal_to_first"] for r in rows if r["seed"] == SEED):
        fail(f"path 8c repeated: a run of seed {SEED} did not repeat the "
             "first bit for bit")


def checkpoint_roundtrip(torch, net):
    """Save the trained net as the f16 checkpoint with its config, reload
    it through ``MatNetInference``'s npz route, and compare its maps on
    photo_e2e with the in-memory net at the f16-rounded weights (<= 1e-4)."""
    import copy
    from materialist_tpu_torch.io import exr as exr_io
    from materialist_tpu_torch.models import train as tr
    from materialist_tpu_torch.models.matnet import MatNetInference
    log("[path 8d] f16 checkpoint of the trained net through "
        "MatNetInference's npz route")
    photo = exr_io.read(os.path.join(PHOTO_E2E, "gt_image.exr"))[..., :3]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        path = os.path.join(tmp, "matnet_scratch.npz")
        tr.save_checkpoint(path, net, PATH8_STEPS,
                           config=net.encoder_config(), half=True)
        size = os.path.getsize(path) / 1e6
        got = MatNetInference(weights_path=path).infer_image(photo)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rounded = copy.deepcopy(net)
    with torch.no_grad():
        for p in rounded.parameters():
            p.copy_(p.half().float())
    ref = MatNetInference(params=rounded.state_dict(),
                          net=copy.deepcopy(rounded)).infer_image(photo)
    log(f"  checkpoint {size:.1f} MB")
    _map_errors(got, ref, "reloaded f16 checkpoint vs the f16-rounded net",
                1e-4)


def disk_route(torch, _lib):
    """``generate`` (2 scenes x 2 at 70x98, 8 spp, "exact" march) into a
    temporary dir, then ``train`` (vit-b, seeded, frozen, batch 2, lr 3e-4,
    6 epochs) on it at PyTorch's default flags: the mean of the last 3
    losses under 0.9 of the first, frozen tensors unchanged. Returns the
    launches of ``generate``."""
    from materialist_tpu_torch.cli.make_mg_dataset import generate
    from materialist_tpu_torch.models import train as tr
    from materialist_tpu_torch.models.dpt import MaterialNet
    log("[path 8e] generate 2x2 tuples at 70x98, 8 spp; train the vit-b "
        "net (seeded, frozen) 6 epochs on them")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mg_")
    try:
        _, launches, sec = _drive(torch, _lib, lambda: generate(
            tmp, 2, 2, 70, 98, 8, seed=SEED))
        _path8_counters(launches, ("shade_bounce_fwd", "row_gather",
                                   "env_sample_dir", "bounce_record",
                                   "env_lookup_bilinear"), "generate")
        log(f"  generate {sec:.2f} s")
        params = MaterialNet(
            generator=torch.Generator().manual_seed(SEED)).state_dict()
        torch.cuda.reset_peak_memory_stats()
        with tf32_defaults(torch):
            t0 = time.perf_counter()
            net, hist = tr.train(tmp, params=params, epochs=6, batch_size=2,
                                 lr=3e-4, im_hw=(70, 98), log_every=4,
                                 return_history=True)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    train = tr.trainable_names(net)
    frozen_same = all(torch.equal(v.cpu(), params[k])
                      for k, v in net.state_dict().items() if k not in train)
    last = sum(hist[-3:]) / 3
    log(f"  losses {[round(h, 4) for h in hist]}; last 3 mean {last:.4f} "
        f"(< 0.9 x first {hist[0]:.4f}); frozen unchanged {frozen_same}; "
        f"{len(hist)} steps in {sec:.2f} s = {sec / len(hist) * 1e3:.1f} ms "
        f"per step (host clock, loading included); peak memory "
        f"{peak / 2**30:.3f} GiB")
    if len(hist) != 12 or not all(math.isfinite(h) for h in hist):
        fail("path 8: train gave no 12 finite losses")
    if not (last < 0.9 * hist[0] and frozen_same):
        fail("path 8: the disk route's loss did not fall, or a frozen "
             "tensor moved")
    return launches


# ---------------------------------------------------- path 10: the bench

BENCH_RES = 1024
# full width (1024² × 64 spp, probed caps), reduced depth
BENCH_ARGS = ["--res", str(BENCH_RES), "--fresh-iters", "2",
              "--trace-every", "2", "--relight-frames", "2"]
# the step launches every kernel of the main path; the relight A–E
STEP_KERNELS = ("march_pair", "shade_bounce_fwd", "shade_bounce_bwd",
                "row_gather", "row_scatter_add", "row_scatter_add_bf16",
                "row_scatter_add_coherent", "compact_sel", "env_sample_dir",
                "bounce_record", "env_lookup_bilinear", "threefry_draw")
RELIGHT_KERNELS = ("march_pair", "shade_bounce_fwd", "row_gather",
                   "env_sample_dir", "bounce_record", "env_lookup_bilinear",
                   "threefry_draw")


def bench_path(torch, _lib):
    """Path 10: the port's bench (``materialist_tpu_torch/bench.py``)
    through its ``main``, in this process, at ``BENCH_ARGS``; its output
    goes to the log. Fails unless its times are finite and positive, no
    compaction cap saturates, the step launches every main-path kernel
    and the relight A–E and none of the gradient's or compaction's.
    Returns (the path's launches, dict(by_shape=the launches of one fresh
    iteration by (kernel, shape), caps=, chunk=, replay_blob=: its
    plan))."""
    import io

    from materialist_tpu_torch import bench
    log(f"[path 10] python -m materialist_tpu_torch.bench "
        f"{' '.join(BENCH_ARGS)}")
    buf = io.StringIO()
    _lib.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            report = bench.main(BENCH_ARGS)
    finally:
        for line in buf.getvalue().splitlines():
            log(f"  [path 10] {line}")
    launches = dict(_lib.LAUNCHES)
    res, busy = report["result"], report["busy"]
    log(f"[path 10] {time.perf_counter() - t0:.1f} s; groups "
        f"{report['groups']}, chunk {report['chunk']}, replay "
        f"{report['replay_blob']}, caps {report['caps']}, cap_util "
        f"{report['cap_util']}, peak "
        f"{report['peak_bytes'] / 2 ** 30:.2f} GiB; one profiled iteration: "
        f"busy {busy['busy_ms']:.1f} ms ({busy['busy_share_of_fresh']:.3f} "
        f"of a fresh one), {busy['device_ops']} device operations, the "
        f"port's kernels {busy['port_kernels_ms']:.1f} ms")
    last = json.loads(buf.getvalue().strip().splitlines()[-1])
    if last != res or res["metric"] != (
            f"inverse_opt_fresh_trace_ms_per_iter_{BENCH_RES}sq_64spp"
            "_measured"):
        fail(f"path 10: unexpected result line {last}")
    times = [res["value"], res["amortized_ms_per_iter"],
             res["trace_pass_ms"], res["relight_fps"], *res["fresh_ms_each"]]
    if len(res["fresh_ms_each"]) != 2 or not all(
            isinstance(t, float) and math.isfinite(t) and t > 0
            for t in times):
        fail(f"path 10: times not finite and positive: {res}")
    if not report["caps"] or any(u >= 0.999
                                 for u in report["cap_util"].values()):
        fail(f"path 10: caps {report['caps']}, cap_util "
             f"{report['cap_util']}: a cap saturated (or none was probed)")
    missing = [k for k in STEP_KERNELS if not report["launches"].get(k)]
    if missing:
        fail(f"path 10: the step launched no {missing}")
    relight = report["relight_launches"]
    if any(relight.get(k) for k in NO_GRAD_NONE_OF) or not all(
            relight.get(k) for k in RELIGHT_KERNELS):
        fail(f"path 10: the relight launched {relight}")
    log(f"  path 10 launches: { {k: v for k, v in launches.items() if v} }")
    info = dict(caps=report["caps"], chunk=report["chunk"],
                replay_blob=report["replay_blob"], by_shape={})
    for key, v in report["launches_by_shape"].items():
        name, _, shp = key.partition(" ")
        info["by_shape"][(name, tuple(json.loads(shp)))] = v
    del report
    torch.cuda.empty_cache()
    return launches, info


# ---------------------------------------------------- path 9: multi-device

def _photo_scene_arrays():
    """photo_e2e as the numpy scene of ``parallel/dryrun.py``: depth,
    best_results maps and envmap, and the photo as the target."""
    from materialist_tpu_torch.io import image as image_io
    d = os.path.join(REPO, "output_imgs", "runs", "photo_e2e")
    mat, depth = _scene_inputs(d)
    return dict(depth=depth, flip_depth=True, albedo=mat["albedo"],
                roughness=mat["roughness"], metallic=mat["metallic"],
                envmap=image_io.read(os.path.join(d, "best_results",
                                                  "envmap.hdr")),
                gt=mat["gt_image"])


def _max_rel(a, b):
    """max |a - b| over max |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _path9a_rank(dev, scene, cfg_fields):
    """Path 9a in its rank (world 1, nccl): the spp-sharded render and
    train step against the unsharded ones, the unsharded step twice.
    Returns numbers only."""
    import torch
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.ops.kernels import _lib
    from materialist_tpu_torch.parallel import dryrun
    from materialist_tpu_torch.parallel.mesh import make_mesh
    from materialist_tpu_torch.parallel.sharding import (
        image_loss, make_sharded_train_step, spp_sharded_render)
    from materialist_tpu_torch.render.shader import (RenderConfig,
                                                     render_with_bsdf)
    cfg = RenderConfig(**cfg_fields)
    cam, gbuf, params, gt = dryrun.scene_on(scene, dev)
    mesh = make_mesh(1, "spp", dev.type)
    _lib.reset_launches()
    key = rng.key(SEED + 7)
    t0 = time.perf_counter()
    img = spp_sharded_render(mesh, cfg, cam)(key, gbuf, params["mats"],
                                             params["envmap"])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    with torch.no_grad():
        ref = render_with_bsdf(key, cfg, cam, gbuf, params["mats"],
                               params["envmap"])
    out = dict(render_equal=bool(torch.equal(img, ref)),
               render_max_abs=float((img - ref).abs().max()),
               render_s=render_s, image_shape=list(img.shape),
               image_finite=bool(torch.isfinite(img).all()))

    def step(sharded):
        _, _, p, _ = dryrun.scene_on(scene, dev)
        opt = torch.optim.Adam(dryrun.leaves(p), lr=1e-3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if sharded:
            loss = make_sharded_train_step(mesh, cfg, cam, opt)(
                p, rng.key(SEED + 8), gbuf, gt)
        else:
            loss = image_loss(render_with_bsdf(
                rng.key(SEED + 8), cfg, cam, gbuf, p["mats"], p["envmap"]),
                gt)
            loss.backward()
            opt.step()
            loss = loss.detach()
        torch.cuda.synchronize()
        lv = dryrun.leaves(p)
        return (loss, [t.grad for t in lv], [t.detach() for t in lv],
                time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev))

    sh, r1, r2 = step(True), step(False), step(False)

    def same(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))
    out.update(
        loss=float(sh[0]), loss_equal=bool(torch.equal(sh[0], r1[0])),
        grads_equal=same(sh[1], r1[1]), params_equal=same(sh[2], r1[2]),
        repeat_grads_equal=same(r1[1], r2[1]),
        repeat_params_equal=same(r1[2], r2[2]),
        grads_max_rel=max(_max_rel(a, b) for a, b in zip(sh[1], r1[1])),
        repeat_grads_max_rel=max(_max_rel(a, b)
                                 for a, b in zip(r2[1], r1[1])),
        params_flip_frac=max(float(((a - b).abs() > 1e-5 + 1e-4 * b.abs())
                                   .float().mean())
                             for a, b in zip(sh[2], r1[2])),
        grads_finite=all(bool(torch.isfinite(g).all()) for g in sh[1]),
        step_s=[sh[3], r1[3], r2[3]], peak_bytes=[sh[4], r1[4], r2[4]],
        launches=dict(_lib.LAUNCHES))
    return out


def multi_device_path(torch, _lib, caps, main_launches):
    """Path 9 on photo_e2e at the main path's width (512², 64 spp, chunk
    4, max_depth 4, the probed caps, film jitter 0.5):
    9a, one nccl rank: the spp-sharded render and train step against the
    unsharded ones (the render and the loss bit for bit; the gradients
    and parameters bit for bit where two unsharded steps agree bit for
    bit, else within 1e-5 of the gradient's maximum and JAX's flip
    fraction of 1%);
    9b, two gloo ranks on the one card with CUDA tensors: the four asserts
    of ``parallel/dryrun.py``, each printed as it passes, each rank's
    peak memory, and its slice's cap utilization (a saturated cap fails);
    9c, ``opt/accum.py``: the split accumulation in 4 groups of 16 spp
    against one autograd backward through the mean of the same renders
    (gradients within 1e-5 of their maximum), the peak memory of each.
    Returns the launches of the three, summed over the ranks."""
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.opt.accum import \
        make_accum_value_and_grad_split
    from materialist_tpu_torch.opt.loop import InverseOptions, _render_cfg
    from materialist_tpu_torch.parallel import dryrun
    from materialist_tpu_torch.parallel.sharding import image_loss
    from materialist_tpu_torch.render import shader

    scene = _photo_scene_arrays()
    cfg_fields = _render_cfg(InverseOptions())._replace(
        compact_caps=tuple(caps))._asdict()
    log(f"[path 9] multi-device layer on photo_e2e at 512x512x"
        f"{cfg_fields['spp']}spp, chunk {cfg_fields['chunk']}, max_depth "
        f"{cfg_fields['max_depth']}, caps {cfg_fields['compact_caps']}")
    torch.cuda.empty_cache()
    total = {k: 0 for k in _lib.LAUNCHES}

    def add(launches):
        for k, v in (launches or {}).items():
            total[k] += v

    log("[path 9a] world 1, nccl: spp-sharded against unsharded")
    t0 = time.perf_counter()
    a = dryrun.run_ranks(_path9a_rank, 1, args=(scene, cfg_fields),
                         device=DEV, timeout=600)[0]
    add(a.pop("launches"))
    log(f"  {time.perf_counter() - t0:.1f} s with the spawn; "
        + json.dumps(a))
    if not (a["render_equal"] and a["image_finite"]
            and a["image_shape"] == [*scene["depth"].shape, 3]):
        fail("path 9a: the spp-sharded render is not the unsharded one bit "
             "for bit")
    if not (a["loss_equal"] and a["grads_finite"]):
        fail("path 9a: the spp-sharded step's loss is not the unsharded "
             "one's")
    if a["repeat_grads_equal"] and a["repeat_params_equal"]:
        if not (a["grads_equal"] and a["params_equal"]):
            fail("path 9a: the unsharded step repeats bit for bit but the "
                 "spp-sharded step differs from it")
        log("  9a: render, loss, gradients and parameters equal bit for bit")
    else:
        # the float atomics of the scatter-add adjoints sum in a varying
        # order: two unsharded steps already differ in the last bits
        if a["grads_max_rel"] > 1e-5 or a["params_flip_frac"] > 0.01:
            fail("path 9a: the spp-sharded step's gradients or parameters "
                 "are outside the bounds")
        log("  9a: render and loss equal bit for bit; two unsharded steps "
            f"differ by {a['repeat_grads_max_rel']:.2e} of the gradient's "
            f"maximum, the sharded step by {a['grads_max_rel']:.2e}")

    log("[path 9b] two gloo ranks on the one card, CUDA tensors: the four "
        "asserts")
    t0 = time.perf_counter()
    res = dryrun.run_ranks(dryrun.dryrun_rank, 2,
                           args=(scene, cfg_fields, 1e-3), device=DEV,
                           timeout=900)
    for r, out in enumerate(res):
        add(out["launches"])
        if len(out["lines"]) != 4 or out["foreign_modules"]:
            fail(f"path 9b: rank {r} returned {out}")
        LOG.extend(f"  rank {r}: {ln}" for ln in out["lines"])
        # the caps were probed on the whole film; a half-film slice with
        # more live rays than the film's average could fill them
        util = out["cap_util"]
        log(f"  rank {r}: its slice's cap_util per bounce {util}")
        if sorted(util) != [1, 2] or any(u >= 0.999 for u in util.values()):
            fail(f"path 9b: a compaction cap of rank {r}'s slice saturated "
                 f"or was not used: {util}")
    log(f"  9b: four asserts passed on both ranks in "
        f"{time.perf_counter() - t0:.1f} s with the spawn; peak memory per "
        "rank GiB "
        + ", ".join(f"{(o['peak_bytes'] or 0) / 2**30:.2f}" for o in res))

    log("[path 9c] opt/accum.py: 4 groups of 16 spp against one backward")
    dev = torch.device(DEV)
    cfg = shader.RenderConfig(**dict(cfg_fields, spp=16))
    n_groups = 4

    def run():
        cam, gbuf, p, gt = dryrun.scene_on(scene, dev)

        def trace_fn(q, key):
            return shader.trace_step_records(key, cfg, cam, gbuf, q["mats"],
                                             q["envmap"])

        def shade_fn(q, recs, key):
            return shader.shade_from_records(key, recs, cfg, cam, gbuf,
                                             q["mats"], q["envmap"])

        def loss_of_img(img):
            return image_loss(img, gt)

        key = rng.key(SEED + 9)
        out = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, grads = make_accum_value_and_grad_split(
            trace_fn, shade_fn, loss_of_img, n_groups)(p, key)
        torch.cuda.synchronize()
        out["accum"] = (float(loss), time.perf_counter() - t0,
                        torch.cuda.max_memory_allocated(dev))
        g_acc = [*grads["mats"][:3], grads["envmap"]]
        _, _, p, _ = dryrun.scene_on(scene, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        keys = rng.split(key, n_groups)
        img = sum(shader.render_with_bsdf(keys[g], cfg, cam, gbuf,
                                          p["mats"], p["envmap"])
                  for g in range(n_groups)) / n_groups
        loss = loss_of_img(img)
        loss.backward()
        torch.cuda.synchronize()
        out["monolithic"] = (float(loss.detach()), time.perf_counter() - t0,
                             torch.cuda.max_memory_allocated(dev))
        out["grad_max_rel"] = [_max_rel(a, b.grad) for a, b in
                               zip(g_acc, dryrun.leaves(p))]
        return out

    c, launches, _ = _drive(torch, _lib, run)
    add(launches)
    (l_a, s_a, pk_a), (l_m, s_m, pk_m) = c["accum"], c["monolithic"]
    log(f"  accum loss {l_a:.7f}, {s_a:.2f} s, peak {pk_a / 2**30:.2f} GiB "
        f"| monolithic loss {l_m:.7f}, {s_m:.2f} s, peak "
        f"{pk_m / 2**30:.2f} GiB; gradient max |d| / max "
        f"{['%.2e' % x for x in c['grad_max_rel']]} (bound 1e-5)")
    if abs(l_a - l_m) > 1e-6 * abs(l_m) or max(c["grad_max_rel"]) > 1e-5:
        fail("path 9c: the accumulation differs from the monolithic "
             "backward")
    missing = [k for k, v in main_launches.items() if v and not total[k]]
    if missing:
        fail(f"path 9 launched no {missing}")
    log(f"  path 9 launches: { {k: v for k, v in total.items() if v} }")
    return total


if __name__ == "__main__":
    main()
