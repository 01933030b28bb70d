"""ctypes loader for the framework's native library (native/*.cpp).

Builds the shared library on first use if it is missing (g++ + zlib, no
external deps) and memoizes the handle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmaterialist_native.so")

_lock = threading.Lock()
_lib = None


def _build():
    subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                   capture_output=True)


def load():
    """Return the loaded native library, building it if necessary."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = [os.path.join(_NATIVE_DIR, f) for f in os.listdir(_NATIVE_DIR)
                if f.endswith(".cpp")]
        if not os.path.exists(_LIB_PATH) or any(
                os.path.getmtime(s) > os.path.getmtime(_LIB_PATH)
                for s in srcs):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)

        lib.exr_read.restype = ctypes.c_int
        lib.exr_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_char_p),
        ]
        lib.exr_write.restype = ctypes.c_int
        lib.exr_write.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.exr_last_error.restype = ctypes.c_char_p
        lib.exr_free.argtypes = [ctypes.c_void_p]

        lib.mesh_build.restype = ctypes.c_void_p
        lib.mesh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double,
        ]
        lib.mesh_counts.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mesh_copy.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.mesh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
