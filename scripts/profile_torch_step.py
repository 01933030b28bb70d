#!/usr/bin/env python3
"""Where one inverse step, or one forward pass, of the PyTorch/CUDA package
spends its time.

Run on a machine with one NVIDIA GPU, from the root of a checkout:

    python3 scripts/profile_torch_step.py            # the inverse step
    python3 scripts/profile_torch_step.py --forward  # one relight pass

It builds an envmap phase step (``opt/step.py::make_phase_step``) on the
in-repo photo_e2e scene at 512² × 64 spp, chunk 4, max_depth 4, without
and with wavefront compaction (caps from ``probe_compact_caps``), runs
each once to warm up, and then times, in the order plain, compacted,
compacted, plain: the trace and the step on the host clock (ending in a
synchronise), the device-busy time from ``torch.profiler`` (the sum of
the device time of every kernel), the number of kernels launched, and
the ten kernels that take the most device time. One JSON line per run;
the card's name and power limit first.

``--forward`` takes one 64-spp pass of ``render/forward.py::
render_averaged`` on the same scene (chunk 8, film jitter 0.5, the scene's
own envmap) instead, the render and the denoiser apart: after a warm-up,
twice under the profiler and twice without.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def forward_pass(torch, chip_smoke):
    """One 64-spp relight pass: render and denoise, each timed alone."""
    from torch.profiler import ProfilerActivity, profile

    from materialist_tpu_torch import rng
    from materialist_tpu_torch.render.denoise import atrous_denoise
    from materialist_tpu_torch.render.shader import (RenderConfig,
                                                     render_with_bsdf)
    from materialist_tpu_torch.utils.profiling import device_summary
    cam, gbuf, mats, env = chip_smoke.photo_scene(torch, torch.device("cuda"))
    cfg = RenderConfig(spp=64, chunk=8, film_jitter=0.5)

    def one(label, profiled):
        out = {"run": label}
        img = None
        for part in ("render", "denoise"):
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) \
                if profiled else None
            torch.cuda.synchronize()
            if prof is not None:
                prof.start()
            t0 = time.perf_counter()
            with torch.no_grad():
                if part == "render":
                    img = render_with_bsdf(rng.key(1), cfg, cam, gbuf, mats,
                                           env)
                else:
                    atrous_denoise(img, albedo=mats.albedo,
                                   normal=mats.normal)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out[part] = {"ms": ms}
            if prof is not None:
                prof.stop()
                out[part].update(device_summary(prof, ms))
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out

    one("warm-up", False)
    for label, profiled in (("profiled", True), ("profiled", True),
                            ("no profiler", False), ("no profiler", False)):
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(one(label, profiled)), flush=True)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forward", action="store_true",
                    help="profile one forward (relight) pass instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    import chip_smoke
    from materialist_tpu_torch import rng
    from materialist_tpu_torch.ops.color import linear_to_srgb
    from materialist_tpu_torch.opt import schedules
    from materialist_tpu_torch.opt.step import make_phase_step
    from materialist_tpu_torch.render.shader import (RenderConfig,
                                                     probe_compact_caps)
    from materialist_tpu_torch.utils.profiling import device_summary

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if args.forward:
        return forward_pass(torch, chip_smoke)
    dev = torch.device("cuda")
    cam, gbuf, mats, env = chip_smoke.photo_scene(torch, dev)
    gt = linear_to_srgb(torch.rand((512, 512, 3), device=dev,
                                   generator=torch.Generator(dev)
                                   .manual_seed(0)))
    base = RenderConfig(spp=64, chunk=4, film_jitter=0.5)
    caps = probe_compact_caps(rng.key(99), base, cam, gbuf, mats,
                              torch.ones_like(env))
    print(f"compact_caps {caps}", flush=True)

    def loss_of(maps, img, extra):
        return torch.mean((linear_to_srgb(img) - gt) ** 2), None

    def one(cfg, label, prof):
        params = {"envmap": env.clone().requires_grad_()}
        phase = make_phase_step(cfg, cam, gbuf,
                                lambda p, extra: (extra, p["envmap"]),
                                loss_of)
        opt = schedules.adam_plain(1e-3)
        state = opt.init(list(params.values()))
        step = phase.make_step(opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = phase.trace_all(params, mats, rng.key(1))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(params, state, mats, recs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = {"run": label, "trace_ms": (t1 - t0) * 1e3,
               "step_ms": (t2 - t1) * 1e3,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if prof is not None:
            prof.stop()
            out.update(device_summary(prof, (t2 - t0) * 1e3))
        return out

    variants = {"plain": base, "compacted": base._replace(compact_caps=caps)}
    for label in ("plain", "compacted"):
        one(variants[label], label + " (warm-up)", None)
    for label in ("plain", "compacted", "compacted", "plain"):
        torch.cuda.reset_peak_memory_stats()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        print(json.dumps(one(variants[label], label, prof)), flush=True)
    # the same four without the profiler, whose hooks slow the host
    for label in ("plain", "compacted", "compacted", "plain"):
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps(one(variants[label], label + " (no profiler)",
                             None)), flush=True)


if __name__ == "__main__":
    main()
