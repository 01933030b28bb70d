"""Build, load and count the port's CUDA kernels.

The sources under ``materialist_tpu_torch/csrc/`` have a plain C
interface. At first use each ``.cu`` is compiled by its own ``nvcc``
process (all started together) and the objects are linked into one
shared library under ``materialist_tpu_torch/build/``, loaded with
``ctypes``. Nothing is built when a module is imported.

``LAUNCHES`` counts kernel launches by name and ``LAUNCHES_BY_SHAPE`` by
name and shape: a wrapper calls ``count_launch`` where it launches its
kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD = os.path.join(PKG_DIR, "build")
LIB_PATH = os.path.join(BUILD, "libmaterialist_kernels.so")
SOURCES = ("envkernels.cu", "gathers.cu", "march_pair.cu", "primary.cu",
           "rowops.cu", "shadebounce.cu", "threefry.cu")
# -fmad=false: no multiply-add contraction, so each kernel rounds where its
# plain version does (the march's hit decisions follow the float order)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

LAUNCHES = {name: 0 for name in (
    "march_pair", "march_single", "shade_bounce_fwd", "shade_bounce_bwd",
    "row_gather", "row_scatter_add", "row_scatter_add_bf16",
    "row_scatter_add_coherent", "compact_sel", "env_sample_dir",
    "env_pdf_dir", "env_lookup_bilinear", "onehot_gather", "vreg_gather",
    "threefry_draw", "bounce_record", "primary_state")}

# (name, shape tuple) -> launches; each wrapper says what its shape lists
LAUNCHES_BY_SHAPE = {}
# kernels that one counted launch runs where it is more than one
# (compact_sel: its count and its write kernel)
KERNELS_PER_LAUNCH = {"compact_sel": 2}

_lock = threading.Lock()
_lib = None
BUILD_SECONDS = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()


def count_launch(name: str, shape=None) -> None:
    """One launch of kernel ``name``, at ``shape`` where the wrapper
    gives one."""
    LAUNCHES[name] += 1
    if shape is not None:
        key = (name, tuple(shape))
        LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def kernel_names() -> tuple:
    """The ``__global__`` functions of ``SOURCES``, the names under which
    a profiler lists the port's kernels."""
    import re
    names = []
    for src in SOURCES:
        with open(os.path.join(CSRC, src)) as f:
            names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\s*\([^)]*\)\s+)?(\w+)\s*\(", f.read())
    return tuple(names)


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    t = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(CSRC, f)) > t
               for f in os.listdir(CSRC))


def build(verbose: bool = False) -> float:
    """Compile every source in parallel and link one library. Returns the
    seconds taken (0 when the library is up to date)."""
    import time
    t0 = time.perf_counter()
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, "build.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not _stale():
            return 0.0
        nvcc = _nvcc()
        procs = []
        objs = []
        for src in SOURCES:
            obj = os.path.join(BUILD, src.replace(".cu", ".o"))
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                   os.path.join(CSRC, src), "-o", obj]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            if verbose or p.returncode:
                print(f"[nvcc {src}]\n{out}", flush=True)
            if p.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}")
        tmp = LIB_PATH + ".tmp"
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
                       check=True)
        os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_uint

_SIGNATURES = {
    "march_pair_launch": ([_P] * 10 + [_I] * 10 + [_F] * 6 + [_I] * 4
                          + [_F] * 2 + [_I] + [_P]),
    "march_single_launch": ([_P] * 8 + [_I] * 10 + [_F] * 6 + [_I] * 2 + [_F]
                            + [_I] + [_P]),
    "shade_bounce_fwd_launch": [_P] * 8 + [_I] * 3 + [_P],
    "shade_bounce_bwd_launch": [_P] * 11 + [_I] * 3 + [_P],
    "row_gather_launch": [_P] * 3 + [_I] * 3 + [_P],
    "row_scatter_add_launch": [_P] * 3 + [_I] * 6 + [_P],
    "compact_sel_launch": [_P] * 4 + [_I] * 2 + [_P],
    "env_sample_dir_launch": [_P] * 8 + [_I] * 3 + [_P],
    "env_pdf_dir_launch": [_P] * 4 + [_I] * 3 + [_P],
    "env_lookup_bilinear_launch": [_P] * 6 + [_I] * 3 + [_P],
    "onehot_gather_launch": [_P] * 3 + [_I] * 2 + [_P],
    "vreg_gather_launch": [_P] * 3 + [_I] * 2 + [_P],
    "threefry_launch": [_P, _I, _L, _I, _I, _U, _U, _F, _F, _P],
    "bounce_record_launch": ([_P] * 8 + [_L] * 2 + [_P] + [_L] * 3 + [_P] * 3
                             + [_I] * 4 + [_F] * 2 + [_P]),
    "primary_state_launch": [_P] * 8 + [_I] * 5 + [_F] * 4 + [_P],
}


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib, BUILD_SECONDS
    with _lock:
        if _lib is None:
            BUILD_SECONDS = build()
            handle = ctypes.CDLL(LIB_PATH)
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaGetLastError() from a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: error {rc}")


def expect(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    """Wrapper argument check: device, dtype, shape and contiguity."""
    if not torch.is_tensor(t):
        raise TypeError(f"{name}: expected a tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
