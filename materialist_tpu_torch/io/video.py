"""Video/GIF assembly from saved frames.

Role of create_video_from_frames (inverse_img_w_mi.py:602-612) and the
rolling-envmap mp4/gif writer (render_final.py:405-416). This image has no
ffmpeg, so mp4 is attempted via OpenCV's VideoWriter and falls back to an
animated GIF next to the requested path.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
from PIL import Image

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def _load_frames(paths):
    return [np.asarray(Image.open(p).convert("RGB")) for p in paths]


def write_gif(frame_paths, out_path, fps: int = 10) -> str:
    frames = [Image.fromarray(f) for f in _load_frames(frame_paths)]
    if not frames:
        return out_path
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return out_path


def write_video(frame_paths, out_path, fps: int = 10) -> str:
    """Write an mp4 (cv2) or fall back to GIF. Returns the path written."""
    if not frame_paths:
        warnings.warn(f"no frames for video {out_path}")
        return out_path
    frames = _load_frames(frame_paths)
    h, w = frames[0].shape[:2]
    if cv2 is not None:
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        if writer.isOpened():
            for f in frames:
                writer.write(f[..., ::-1])
            writer.release()
            if os.path.getsize(out_path) > 0:
                return out_path
    gif_path = os.path.splitext(out_path)[0] + ".gif"
    warnings.warn(f"mp4 encoder unavailable; writing {gif_path}")
    return write_gif(frame_paths, gif_path, fps)
