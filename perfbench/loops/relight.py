"""Loop ``relight``: a closed loop of relight passes, each
``render/forward.py::render_averaged`` with ``n_iter`` renders of ``spp``
samples (chunks of ``chunk``, film jitter), denoised, read back to the
host, as ``render_final --mode real`` makes each of its images. Pass i
takes the seed seed·2^16 + i. Set-up renders pass 0, which warms every
shape.

After the window the plain reference renders a sample of the window's
passes again, drawn from the seed, and denoises them; each pass's image
is compared with it.
"""

from __future__ import annotations

import contextlib
import random

import numpy as np
import torch

from perfbench.reference import tracer as T

LABELS = ("pass", "render", "denoise")
PASS_STRIDE = 1 << 16


class Loop:
    unit_name = "pass"

    def __init__(self, conf: dict, traffic: dict, seed: int, dev, log):
        from materialist_tpu_torch.camera import Camera
        from materialist_tpu_torch.render.scene import Materials, make_gbuffer

        from perfbench import inputs

        self.conf, self.traffic, self.seed, self.dev = conf, traffic, seed, dev
        self.inp = inputs.load(conf, "relight", dev)
        res = conf["film"]
        self.cam = Camera(res, res)
        self.gbuf = make_gbuffer(self.inp["depth"], self.cam,
                                 flip_depth=True, device=dev)
        self.mats = Materials(*(self.inp[k] for k in (
            "albedo", "roughness", "metallic", "normal")))
        self.images = {}
        # the check samples passes of the window after it has closed
        self.sampled = -1
        self.unit(0)
        self.images.clear()
        self.next = 1

    def pass_seed(self, i: int) -> int:
        return self.seed * PASS_STRIDE + i

    def unit(self, i: int, span=None):
        """Pass i; returns whether its image is finite."""
        from materialist_tpu_torch.render.forward import render_averaged
        span = span or (lambda label: contextlib.nullcontext())
        t = self.traffic
        with span("pass"):
            img = render_averaged(self.gbuf, self.cam, self.mats,
                                  self.inp["envmap"], n_iter=t["n_iter"],
                                  spp=t["spp"], denoise=t["denoise"],
                                  seed=self.pass_seed(i), chunk=t["chunk"],
                                  film_jitter=t["film_jitter"])
        self.images[i] = img
        return float(np.abs(img).sum()) if np.isfinite(img).all() \
            else float("nan")

    @contextlib.contextmanager
    def instrument(self, span):
        """Spans around the pass's renders and denoises: the forward
        module's two calls, wrapped while the context is open."""
        from materialist_tpu_torch.render import forward
        orig = forward.render_with_bsdf, forward.atrous_denoise

        def wrap(fn, label):
            def inner(*a, **k):
                with span(label):
                    return fn(*a, **k)
            return inner

        forward.render_with_bsdf = wrap(orig[0], "render")
        forward.atrous_denoise = wrap(orig[1], "denoise")
        try:
            yield
        finally:
            forward.render_with_bsdf, forward.atrous_denoise = orig

    def free(self):
        self.gbuf = self.mats = None

    def check(self, limits: dict, log):
        """The reference's images of a sample of the window's passes:
        (numbers, readings)."""
        done = sorted(self.images)
        pick = random.Random(self.seed).sample(
            done, min(self.traffic["check_passes"], len(done)))
        gaps = []
        for i in sorted(pick):
            ref = reference_image(self.conf, self.traffic, self.inp,
                                  self.pass_seed(i))
            gaps.append(image_gap(self.images[i], ref))
            log(f"pass {i}: image gap {gaps[-1]:.6g}")
        nums = {"image_gap": max(gaps)}
        return ({k: {"value": v, "limit": limits.get(k)}
                 for k, v in nums.items()}, gaps)


def image_gap(img, ref) -> float:
    """Σ|img − ref| / Σ|ref| over every pixel and channel."""
    got = torch.as_tensor(np.asarray(img), device=ref.device)
    return float(torch.sum(torch.abs(got - ref)) / torch.sum(torch.abs(ref)))


def reference_image(conf, traffic, inp, pass_seed: int, dtype=torch.float32,
                    fault=None):
    """The plain reference's pass: ``n_iter`` renders from keys
    key(pass_seed + r), each denoised, averaged."""
    from perfbench.reference import rng
    res = conf["film"]
    cam = T.Cam(res, res)
    geo = T.geometry(inp["depth"], cam)
    cfg = T.Cfg(spp=traffic["spp"], chunk=min(traffic["chunk"],
                                              traffic["spp"]),
                film_jitter=traffic["film_jitter"])
    table = T.pack(inp["albedo"], inp["roughness"], inp["metallic"],
                   inp["normal"])
    n_chunks = max(cfg.spp // cfg.chunk, 1)
    chunks = range(n_chunks // 2) if fault == "half" else None
    acc = None
    for r in range(traffic["n_iter"]):
        img = T.render(rng.key(pass_seed + r), cfg, cam, geo, table,
                       inp["envmap"], dtype, chunks, fault)
        if traffic["denoise"]:
            img = T.denoise(img, inp["albedo"], inp["normal"])
        acc = img if acc is None else acc + img
    return acc / traffic["n_iter"]
