"""Host-side image I/O: PNG / HDR / EXR dispatch + resize helpers.

Replaces the reference's mi.Bitmap / mi.util.write_bitmap / torchvision
save_image stack. Write semantics match the reference's outputs:

* ``.exr``  — linear float via the native codec (io/exr.py);
* ``.hdr``  — Radiance RGBE via OpenCV (envmap.hdr, final_envmap.hdr);
* ``.png``  — 8-bit; linear data is converted with the *true sRGB* transfer
  (verified against the shipped gt_image.png/gt_image.exr pair to <1/255).
"""

from __future__ import annotations

import os

import numpy as np

from materialist_tpu_torch.io import exr as exr_io

try:  # cv2 is available in the image; guard anyway
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

from PIL import Image


def srgb_encode(x: np.ndarray) -> np.ndarray:
    """True sRGB OETF (what mi.util.write_bitmap applies for PNG)."""
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x,
                    1.055 * np.power(x, 1.0 / 2.4) - 0.055)


def srgb_decode(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.04045, x / 12.92,
                    np.power((x + 0.055) / 1.055, 2.4))


def read(path: str) -> np.ndarray:
    """Read any supported image as float32.

    EXR/HDR → linear float (H, W, C); PNG/JPG → [0,1] floats *as stored*
    (no transfer conversion — the pipeline decides, matching the reference's
    explicit srgb_to_linear call at inverse_img_w_mi.py:643-645).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return exr_io.read(path)
    if ext == ".hdr":
        if cv2 is None:
            raise RuntimeError("cv2 required for .hdr")
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(f"cannot read {path}")
        return np.ascontiguousarray(img[..., ::-1].astype(np.float32))
    img = np.asarray(Image.open(path))
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def write(path: str, img, linear_input: bool = True) -> None:
    """Write an image, inferring format from the extension.

    For PNG, ``linear_input=True`` applies the sRGB transfer first
    (mi.util.write_bitmap behavior); pass False for data already in [0,1]
    display space (e.g. torchvision-save_image-style frames).
    """
    img = np.asarray(img, dtype=np.float32)
    ext = os.path.splitext(path)[1].lower()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if ext == ".exr":
        exr_io.write(path, img)
        return
    if ext == ".hdr":
        if cv2 is None:
            raise RuntimeError("cv2 required for .hdr")
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]))
        return
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    img = np.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
    data = srgb_encode(img) if linear_input else np.clip(img, 0.0, 1.0)
    Image.fromarray((data * 255.0 + 0.5).astype(np.uint8)).save(path)


def resize_bilinear_align_corners(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize with align_corners=True semantics.

    Matches the reference's F.interpolate(..., align_corners=True) used by
    center_crop_and_resize (misc.py:28) so MaterialNet sees identical pixels.
    """
    h, w = img.shape[:2]
    th, tw = size
    if (h, w) == (th, tw):
        return img.astype(np.float32)
    ys = np.linspace(0.0, h - 1.0, th)
    xs = np.linspace(0.0, w - 1.0, tw)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def center_crop_and_resize(img: np.ndarray, target=(512, 512)) -> np.ndarray:
    """Square center crop + align-corners bilinear resize (misc.py:10-34)."""
    h, w = img.shape[:2]
    m = min(h, w)
    sh, sw = (h - m) // 2, (w - m) // 2
    crop = img[sh:sh + m, sw:sw + m, :3]
    if crop.dtype == np.uint8:
        crop = crop.astype(np.float32) / 255.0
    return resize_bilinear_align_corners(crop.astype(np.float32), target)
