#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA package on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card and its power limit, builds the CUDA kernels from
   ``materialist_tpu_torch/csrc`` and prints the build time;
2. holds every kernel of the main path against its plain PyTorch version
   on the card, at the main path's shapes (M = 4·512² vertices), and
   times kernel, plain version and, for the scatter-add, Tensor.index_add_;
3. drives the main path: ``optimize`` at 512²×64 spp on the in-repo
   photo_e2e scene (envmap → rm-material → envmap phases), with every
   kernel's launch counter read around it;
4. renders and differentiates a 64² scene on the card (kernels) and on
   the CPU (plain versions) from the same keys and compares them;
5. runs the inverse CLI in its resume mode on a copy of the scene;

then prints one JSON line with each kernel's numbers and, last, the
device line. Any failed check exits nonzero before the JSON lines.
Extra output goes to ``chiprun_out/chip_smoke.log``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
DEV = "cuda"
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12        # FP32 outside the tensor cores
FLOPS_PER_MARCH_STEP = 24      # project + compare + updates, per step
FLOPS_SHADE_FWD = 260          # per vertex: 2 BRDF evals, 2 fetches, MIS
FLOPS_SHADE_BWD = 520          # per vertex: forward replay + adjoint
LOG = []


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


def cuda_ms(fn, iters=20, warmup=3):
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
    return s.elapsed_time(e) / iters


def bound(bytes_moved, flops):
    t_b = bytes_moved / H100_BYTES_PER_S * 1e3
    t_o = flops / H100_FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not os.path.isdir(os.path.join(REPO, "materialist_tpu_torch")):
        fail("materialist_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, REPO)
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

    kernels = check_kernels(torch, _lib)
    main_path(torch, _lib, kernels)
    small_agreement(torch)
    cli_run()

    log("kernels: " + ", ".join(
        f"{k['name']}={'ok' if k['ok'] else 'FAIL'}" for k in kernels))
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


def check_kernels(torch, _lib):
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.ops import brdf
    from materialist_tpu_torch.ops import envmap as em
    from materialist_tpu_torch.ops.kernels import envkernels as ek
    from materialist_tpu_torch.ops.kernels import march as mk
    from materialist_tpu_torch.ops.kernels import rowops
    from materialist_tpu_torch.ops.kernels import shadebounce as sb
    from materialist_tpu_torch.opt.loop import InverseOptions, _render_cfg
    from materialist_tpu_torch.render import shader

    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = []
    rel = "materialist_tpu/ops/pallas/"

    def entry(name, src, replaces, ok, err, ms, plain_ms, bytes_moved,
              flops, library_ms=None):
        b_ms, b_by = bound(bytes_moved, flops)
        out.append(dict(name=name, route="cuda",
                        source="materialist_tpu_torch/csrc/" + src,
                        replaces=rel + replaces, launches=0,
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                        ok=ok))
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})"
            + (f", library {library_ms:.4f} ms" if library_ms else ""))
        if not ok:
            fail(f"kernel {name} disagrees with its plain version")

    log("[kernels] main-path shapes, kernel vs plain on the card")
    cam_p, gbuf_p, mats_p, env = photo_scene(torch, dev)
    s = 4
    n = 512 * 512
    m = s * n
    sampler = em.build_sampler(env)

    # ---- A: march_pair on a seeded non-flat depth map
    cam_a, gbuf_a = seeded_depth_scene(torch, dev)
    cfg = _render_cfg(InverseOptions())
    tab = shader.march_tables(cfg, gbuf_a)
    k = rng.split(rng.key(SEED), 3)
    u1 = rng.uniform(k[0], (s, n), dev)
    u2 = rng.uniform(k[1], (s, n, 2), dev)
    u_nee = rng.uniform(k[2], (s, n, 2), dev)
    wo = gbuf_a.wo.reshape(n, 3).expand(s, n, 3)
    nrm = gbuf_a.normal_geo.reshape(n, 3)
    d_lobe = brdf.sample_dirs(u1, u2, wo, nrm,
                              torch.full((n, 1), 0.5, device=dev))
    d_nee, _ = em.sample_dir(sampler, u_nee)
    origin = gbuf_a.position.reshape(n, 3).expand(s, n, 3).contiguous()
    kw = dict(n_steps=cfg.march_steps, fine_steps=cfg.fine_steps,
              shadow_steps=cfg.shadow_steps,
              shadow_fine_steps=cfg.shadow_fine_steps,
              interval_frac=cfg.march_interval_frac)
    hit_k, shad_k = mk.march_pair(cam_a, tab, origin, d_lobe, d_nee, **kw)
    hit_p, shad_p = mk.march_pair_plain(
        cam_a, tab, origin, d_lobe, d_nee, t_min_frac=2e-3, t_max_frac=3.0,
        bias_frac=4e-3, **kw)
    agree = {nm: float((a == b).float().mean()) for nm, a, b in (
        ("hit", hit_k.hit, hit_p.hit), ("idx", hit_k.idx, hit_p.idx),
        ("shadowed", shad_k, shad_p))}
    both = hit_k.hit & hit_p.hit & (hit_k.idx == hit_p.idx)
    t_err = float((hit_k.t - hit_p.t).abs()[both].max()) if both.any() \
        else 0.0
    hit_frac = float(hit_p.hit.float().mean())
    log(f"  march_pair: flags agree {agree} (>= 0.999), hit fraction "
        f"{hit_frac:.3f}, shadowed fraction "
        f"{float(shad_p.float().mean()):.3f}, t max_abs_err {t_err:.3e} "
        "where both hit")
    ok = all(v >= 0.999 for v in agree.values()) and 0.01 < hit_frac < 0.99
    ms = cuda_ms(lambda: mk.march_pair(cam_a, tab, origin, d_lobe, d_nee,
                                       **kw))
    pms = cuda_ms(lambda: mk.march_pair_plain(
        cam_a, tab, origin, d_lobe, d_nee, t_min_frac=2e-3, t_max_frac=3.0,
        bias_frac=4e-3, **kw), iters=3, warmup=1)
    steps = (cfg.march_steps + 2 * cfg.fine_steps + cfg.shadow_steps
             + 2 * max(cfg.shadow_fine_steps, 1))
    entry("march_pair", "march_pair.cu", "march_kernel.py:505", ok, t_err,
          ms, pms, m * (36 + 10) + 4 * (tab.mip.numel() + tab.fine.numel()),
          m * steps * FLOPS_PER_MARCH_STEP)

    # ---- B / B′ on a real trace chunk of the photo scene (bounce 1)
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
    tk, rk = sb.shade_bounce_fwd(*args)
    tp, rp = sb.shade_bounce_fwd_plain(*args)
    ok1, e1 = compare("shade_bounce_fwd thr'", tk, tp, 1e-5 * float(
        tp.abs().max()), 1e-4)
    ok2, e2 = compare("shade_bounce_fwd rad", rk, rp, 1e-5 * float(
        rp.abs().max()), 1e-4)
    ms = cuda_ms(lambda: sb.shade_bounce_fwd(*args))
    pms = cuda_ms(lambda: sb.shade_bounce_fwd_plain(*args), iters=5)
    entry("shade_bounce_fwd", "shadebounce.cu", "shadebounce.py:267",
          ok1 and ok2, max(e1, e2), ms, pms, m * (80 + 24) + envc.numel() * 4,
          m * FLOPS_SHADE_FWD)

    ct_t = torch.randn((m, 3), generator=g, device=dev)
    ct_r = torch.randn((m, 3), generator=g, device=dev)
    gk = sb.shade_bounce_bwd(*args, ct_t, ct_r)
    gp = sb.shade_bounce_bwd_explicit(*args, ct_t, ct_r)
    oks, errs = [], []
    for nm, a, b in zip(("d_blob", "d_thr", "d_le"), gk, gp):
        o, e = compare(f"shade_bounce_bwd {nm}", a, b,
                       1e-5 * float(b.abs().max()), 1e-4)
        oks.append(o)
        errs.append(e)
    ms = cuda_ms(lambda: sb.shade_bounce_bwd(*args, ct_t, ct_r))
    pms = cuda_ms(lambda: sb.shade_bounce_bwd_explicit(*args, ct_t, ct_r),
                  iters=5)
    entry("shade_bounce_bwd", "shadebounce.cu", "shadebounce.py:297",
          all(oks), max(errs), ms, pms, m * (104 + 56) + envc.numel() * 4,
          m * FLOPS_SHADE_BWD)

    # ---- C′: material-table scatter (bf16 payload) and sky adjoint (f32)
    idx_m = r0.idx.reshape(m).to(torch.int32).contiguous()
    cot_m = torch.randn((m, 8), generator=g, device=dev)
    cot_m[:, 5:] = 0.0
    n_tab = n
    for name, cot, idx, rows, exact in (
            ("row_scatter_add_bf16", cot_m, idx_m, n_tab, False),
            ("row_scatter_add", None, None, 512, True)):
        if cot is None:
            u0, v0, du, dv = em.bilinear_coords(
                -gbuf_p.wo.reshape(n, 3), 16, 32)
            w = env.shape[1]
            taps = ((v0, u0, (1 - du) * (1 - dv)),
                    (v0, (u0 + 1) % w, du * (1 - dv)),
                    (torch.clamp(v0 + 1, 0, 15), u0, (1 - du) * dv),
                    (torch.clamp(v0 + 1, 0, 15), (u0 + 1) % w, du * dv))
            base = torch.randn((n, 3), generator=g, device=dev)
            idx = torch.cat([(vi * w + ui).reshape(-1)
                             for vi, ui, _ in taps]).to(torch.int32)
            cot = torch.cat([wt[:, None] * base for _, _, wt in taps])
        ck = rowops.row_scatter_add(cot, idx, rows, exact=exact)
        cp = rowops.row_scatter_add_plain(cot, idx, rows, exact=exact)
        scale = float(cp.abs().max())
        o, e = compare(name, ck, cp, 1e-5 * scale, 1e-5)
        ms = cuda_ms(lambda: rowops.row_scatter_add(cot, idx, rows,
                                                    exact=exact))
        pms = cuda_ms(lambda: rowops.row_scatter_add_plain(cot, idx, rows,
                                                           exact=exact),
                      iters=5)
        il = idx.long()
        cb = cot if exact else cot.to(torch.bfloat16).float()
        lib_ms = cuda_ms(lambda: torch.zeros(
            (rows, cot.shape[1]), device=dev).index_add_(0, il, cb))
        entry(name, "rowops.cu", "rowops.py:189", o, e, ms, pms,
              cot.numel() * 4 + idx.numel() * 4 + rows * cot.shape[1] * 4,
              cot.numel(), library_ms=lib_ms)

    # ---- D, D′, E
    u_s = rng.uniform(rng.key(SEED + 2), (m, 2), dev)
    wk, pk = ek.env_sample_dir(sampler.m_cdf, sampler.m_pdf, sampler.c_cdf,
                               sampler.c_pdf, u_s)
    wp, pp = ek.env_sample_dir_plain(sampler.m_cdf, sampler.m_pdf,
                                     sampler.c_cdf, sampler.c_pdf, u_s)
    o1, e1 = compare("env_sample_dir wi", wk, wp, 1e-5, 1e-5)
    o2, e2 = compare("env_sample_dir pdf", pk, pp, 1e-6, 1e-5)
    tabs = (sampler.m_cdf, sampler.m_pdf, sampler.c_cdf, sampler.c_pdf)
    ms = cuda_ms(lambda: ek.env_sample_dir(*tabs, u_s))
    pms = cuda_ms(lambda: ek.env_sample_dir_plain(*tabs, u_s), iters=5)
    entry("env_sample_dir", "envkernels.cu", "envkernels.py:154", o1 and o2,
          max(e1, e2), ms, pms, m * (8 + 16) + 4 * 2 * (16 + 512),
          m * 120)

    dirs = d_lobe.reshape(m, 3).contiguous()
    pk = ek.env_pdf_dir(sampler.m_pdf, sampler.c_pdf, dirs)
    pp = ek.env_pdf_dir_plain(sampler.m_pdf, sampler.c_pdf, dirs)
    # a direction within an ulp of a texel border may fall in the
    # neighbouring texel: torch divides by a scalar on the card as a
    # multiply by its reciprocal, the kernel (like XLA) divides
    o, e = compare("env_pdf_dir", pk, pp, 1e-6, 1e-5, min_frac=0.9999)
    ms = cuda_ms(lambda: ek.env_pdf_dir(sampler.m_pdf, sampler.c_pdf, dirs))
    pms = cuda_ms(lambda: ek.env_pdf_dir_plain(sampler.m_pdf, sampler.c_pdf,
                                               dirs), iters=5)
    entry("env_pdf_dir", "envkernels.cu", "envkernels.py:317", o, e, ms, pms,
          m * 16 + 4 * (16 + 512), m * 60)

    u0, v0, du, dv = em.bilinear_coords(-gbuf_p.wo.reshape(n, 3), 16, 32)
    u0 = u0.to(torch.int32).contiguous()
    v0 = v0.to(torch.int32).contiguous()
    lk = ek.env_lookup_bilinear(envc, u0, v0, du, dv)
    lp = ek.env_lookup_bilinear_plain(envc, u0, v0, du, dv)
    o, e = compare("env_lookup_bilinear", lk, lp, 1e-6, 1e-6)
    ms = cuda_ms(lambda: ek.env_lookup_bilinear(envc, u0, v0, du, dv))
    pms = cuda_ms(lambda: ek.env_lookup_bilinear_plain(envc, u0, v0, du, dv),
                  iters=5)
    entry("env_lookup_bilinear", "envkernels.cu", "envkernels.py:229", o, e,
          ms, pms, n * (16 + 12) + envc.numel() * 4, n * 3 * 8)
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


def main_path(torch, _lib, kernels):
    from materialist_tpu_torch.camera import Camera
    from materialist_tpu_torch.opt.loop import InverseOptions, optimize
    from materialist_tpu_torch.render.scene import make_gbuffer

    log("[main path] optimize at 512x512x64spp: env -> rm -> env")
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
                              max_loops=2, num_epochs=3, frame_every=0,
                              snapshot_every=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        best = optimize(gbuf, cam, mat, d, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        log(f"  wall {wall:.2f} s, peak memory {peak / 2**30:.2f} GiB")
        for name, tot in best["timer"].items():
            cnt = best["timer_counts"][name]
            log(f"  {name}: {cnt} x {tot / cnt * 1e3:.1f} ms")
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows = [json.loads(x) for x in f]
        losses = [(r["phase"], r["epoch"], r["loss"], r["mse"]) for r in rows]
        log(f"  losses (phase, epoch, loss, mse): {losses}")
        phases = {r["phase"] for r in rows}
        if not all(math.isfinite(r["loss"]) and math.isfinite(r["mse"])
                   for r in rows):
            fail("non-finite loss on the main path")
        if phases != {"env", "mat_mlp[rm]"} or len(rows) != 7:
            fail(f"unexpected phase schedule {sorted(phases)} ({len(rows)})")
        img = best["rendered_img"]
        if tuple(img.shape) != (512, 512, 3) or not bool(
                torch.isfinite(img).all()):
            fail("rendered image is not a finite 512x512x3 image")
        log(f"  launches on the main path: {launches}")
        for k in kernels:
            k["launches"] = launches[k["name"]]
            if k["launches"] <= 0:
                fail(f"kernel {k['name']} was not launched on the main path")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def small_agreement(torch):
    """64² scene rendered and differentiated on the card and on the CPU
    from the same keys: the kernels against the plain versions end to
    end."""
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.camera import Camera
    from materialist_tpu_torch.ops.color import linear_to_srgb
    from materialist_tpu_torch.render.scene import Materials, make_gbuffer
    from materialist_tpu_torch.render.shader import RenderConfig, render

    log("[agreement] 64x64x8spp render + gradients, card vs CPU")
    res = 64
    g = torch.Generator().manual_seed(SEED)
    depth = 2.0 + torch.rand((res, res), generator=g)
    depth[16:40, 10:30] -= 0.8
    cfg = RenderConfig(spp=8, chunk=4, max_depth=4, film_jitter=0.5)
    alb = 0.2 + 0.7 * torch.rand((res, res, 3), generator=g)
    rough = 0.2 + 0.7 * torch.rand((res, res, 1), generator=g)
    met = 0.5 * torch.rand((res, res, 1), generator=g)
    env = (torch.rand((16, 32, 3), generator=g) + 0.1) * 2
    res_out = {}
    for dev in ("cuda", "cpu"):
        cam = Camera(res, res)
        gb = make_gbuffer(depth, cam, flip_depth=False, device=dev)
        leaves = [x.to(dev).requires_grad_() for x in (alb, rough, met, env)]
        mats = Materials(leaves[0], leaves[1], leaves[2], gb.normal_geo)
        img = render(rng.key(3), cfg, cam, gb, mats, leaves[3])
        loss = torch.mean(linear_to_srgb(img) ** 2)
        loss.backward()
        res_out[dev] = [img.detach().cpu()] + [x.grad.cpu() for x in leaves]
    names = ("image", "d_albedo", "d_roughness", "d_metallic", "d_envmap")
    for nm, a, b in zip(names, res_out["cuda"], res_out["cpu"]):
        scale = float(b.abs().max())
        err = (a - b).abs()
        mean_rel = float(err.mean() / b.abs().mean().clamp_min(1e-12))
        log(f"  {nm}: max_abs_err/max {float(err.max()) / scale:.3e}, "
            f"mean rel {mean_rel:.3e}")
        if not bool(torch.isfinite(a).all()) or mean_rel > 2e-2 or \
                float(err.max()) > 0.2 * scale:
            fail(f"card and CPU disagree on {nm}")


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


if __name__ == "__main__":
    main()
