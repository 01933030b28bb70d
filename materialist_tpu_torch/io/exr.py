"""EXR read/write via the native codec (native/exr.cpp).

Replaces the reference's mi.Bitmap / mi.util.write_bitmap EXR path
(myutils/misc.py:99-111, inverse_img_w_mi.py:672-677). Channel handling
matches OpenEXR: files store channels alphabetically (B,G,R[,A]); this
module returns/accepts RGB(A)-ordered numpy arrays.
"""

from __future__ import annotations

import ctypes

import numpy as np

from materialist_tpu_torch.io.native import load as _load_native

_RGBA_ORDER = {"R": 0, "G": 1, "B": 2, "A": 3, "Y": 0}


def read(path: str) -> np.ndarray:
    """Read an EXR into float32 (H, W, C), RGB(A) channel order.

    Single-channel files come back as (H, W, 1).
    """
    lib = _load_native()
    out = ctypes.POINTER(ctypes.c_float)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    names = ctypes.c_char_p()
    rc = lib.exr_read(path.encode(), ctypes.byref(out), ctypes.byref(w),
                      ctypes.byref(h), ctypes.byref(c), ctypes.byref(names))
    if rc != 0:
        raise IOError(
            f"EXR read failed for {path}: "
            f"{lib.exr_last_error().decode(errors='replace')}")
    n = h.value * w.value * c.value
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    chnames = names.value.decode().split(";")
    lib.exr_free(out)
    lib.exr_free(ctypes.cast(names, ctypes.c_void_p))
    img = arr.reshape(h.value, w.value, c.value)
    # reorder file (alphabetical) channels → RGB(A)
    order = sorted(range(len(chnames)),
                   key=lambda i: _RGBA_ORDER.get(chnames[i], 99))
    return np.ascontiguousarray(img[..., order])


def write(path: str, img: np.ndarray, half: bool = False) -> None:
    """Write float32 (H, W[, C]) RGB(A) data as a ZIP-compressed EXR."""
    lib = _load_native()
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = {1: "Y", 3: "R;G;B", 4: "R;G;B;A"}.get(c)
    if names is None:
        raise ValueError(f"unsupported channel count {c}")
    img = np.ascontiguousarray(img)
    rc = lib.exr_write(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w, h, c, names.encode(), 1 if half else 0)
    if rc != 0:
        raise IOError(
            f"EXR write failed for {path}: "
            f"{lib.exr_last_error().decode(errors='replace')}")
