"""Forward re-rendering / relighting entry points (counterpart of
``materialist_tpu/render/forward.py``): n_iter independent renders, each
denoised (``render/denoise.py``) and averaged. Nothing here needs a
gradient, so the renders run under ``torch.no_grad()``: no chunk's trace
records outlive its shade.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from materialist_tpu_torch import rng
from materialist_tpu_torch.camera import Camera
from materialist_tpu_torch.io import image as image_io
from materialist_tpu_torch.io import video as video_io
from materialist_tpu_torch.ops import envmap as em
from materialist_tpu_torch.render.denoise import atrous_denoise
from materialist_tpu_torch.render.scene import GBuffer, Materials
from materialist_tpu_torch.render.shader import (RenderConfig,
                                                 render_with_bsdf)
from materialist_tpu_torch.utils.profiling import span

_PASS = span("forward.pass")
_RENDER = span("forward.render")
_DENOISE = span("forward.denoise")


def _envmap_on(envmap, device):
    """The envmap, a numpy array or a tensor, as float32 on ``device``."""
    return torch.as_tensor(np.asarray(envmap) if not torch.is_tensor(envmap)
                           else envmap, dtype=torch.float32, device=device)


@torch.no_grad()
def render_averaged(gbuf: GBuffer, cam: Camera, mats: Materials, envmap,
                    n_iter: int = 10, spp: int = 64, denoise: bool = True,
                    seed: int = 0, bsdf=None, chunk: int = 8,
                    film_jitter: float = 0.5) -> np.ndarray:
    """n_iter × (spp render [+ denoise]) averaged, on the device of
    ``gbuf``. Continuous in-pixel film sampling is on by default (box
    halfwidth 0.5). The average is taken on the device; one image comes
    back to the host at the end."""
    with _PASS:
        cfg = RenderConfig(spp=spp, chunk=min(chunk, spp),
                           film_jitter=film_jitter)
        envmap = _envmap_on(envmap, gbuf.dist.device)
        acc = None
        for i in range(n_iter):
            with _RENDER:
                img = render_with_bsdf(rng.key(seed + i), cfg, cam, gbuf,
                                       mats, envmap, bsdf)
            if denoise:
                with _DENOISE:
                    img = atrous_denoise(img, albedo=mats.albedo,
                                         normal=mats.normal)
            acc = img if acc is None else acc + img
        return (acc / n_iter).cpu().numpy()


def render_rolling(gbuf: GBuffer, cam: Camera, mats: Materials, envmap,
                   output_dir: str, save_name: str, env_id: str,
                   frames: int = 36, rotation_step: float = 10.0,
                   n_iter: int = 1, spp: int = 32,
                   edit_flag: str = "") -> str:
    """Rolling-envmap relight animation: one frame per rotation step, then
    an mp4 and a gif of them."""
    anim_dir = os.path.join(output_dir, "rolling_envmap_animation")
    os.makedirs(anim_dir, exist_ok=True)
    envmap = _envmap_on(envmap, gbuf.dist.device)
    frame_paths = []
    for f in range(frames):
        angle = f * rotation_step
        rolled = em.rotate(envmap, angle)
        img = render_averaged(gbuf, cam, mats, rolled, n_iter=n_iter,
                              spp=spp, seed=f)
        srgb = np.clip(img, 0, 1) ** (1 / 2.2)
        p = os.path.join(anim_dir, f"frame_{f:04d}.png")
        image_io.write(p, srgb, linear_input=False)
        frame_paths.append(p)
        print(f"frame {f + 1}/{frames} (angle {angle}°)", flush=True)
    mp4 = os.path.join(output_dir,
                       f"rolling_envmap_{save_name}_{env_id}.mp4")
    video_io.write_video(frame_paths, mp4, fps=10)
    gif = os.path.join(output_dir,
                       f"rolling_envmap_{save_name}_{env_id}.gif")
    video_io.write_gif(frame_paths, gif, fps=10)
    return anim_dir
