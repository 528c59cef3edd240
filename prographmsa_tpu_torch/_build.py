"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

The sources have a plain C interface and are bound with ``ctypes``
(pointers, including the CUDA stream, cross as ``c_void_p``); nothing
includes PyTorch's headers, so a build takes seconds.  The shared library
goes into the gitignored ``.build/`` directory of this package, named by a
hash of the sources and flags, and is built at first use.  No
``--use_fast_math``: the kernels replay the host's float32 rounding, so
contraction is off (``--fmad=false``) and division is IEEE.

Every kernel wrapper counts its launches in ``LAUNCHES`` (one per launch,
nowhere else), so a run can show which kernels the main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
SOURCES = ("scores.cu", "fill.cu", "chase.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

KERNELS = ("s_prep", "s", "fill", "chase")
LAUNCHES = {k: 0 for k in KERNELS}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def so_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(_DIR, ".build", "pgm_kernels-%s.so" % h.hexdigest()[:16])


def build() -> str:
    """Compile the kernels unless the hashed library exists; returns its path.
    Records the build seconds and nvcc's register report in ``build_info``."""
    so = so_path()
    if os.path.exists(so):
        build_info.setdefault("seconds", 0.0)
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = "%s.tmp.%d" % (so, os.getpid())
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(_CSRC, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (%d):\n%s" % (proc.returncode,
                                                      proc.stderr[-4000:]))
    os.replace(tmp, so)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["ptxas"] = proc.stderr
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        L = ctypes.CDLL(build())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L.pgm_s_prep.argtypes = [p, p, p, i, i, i, p, p, p]
        L.pgm_s.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, f, f, p, p]
        L.pgm_fill.argtypes = ([p] * 7 + [i] * 7 + [p] * 7 + [p])
        L.pgm_chase.argtypes = [p] * 14 + [i] * 7 + [p, p]
        for fn in (L.pgm_s_prep, L.pgm_s, L.pgm_fill, L.pgm_chase):
            fn.restype = ctypes.c_int
        L.pgm_error_string.argtypes = [i]
        L.pgm_error_string.restype = ctypes.c_char_p
        _lib = L
        return L


def launch(name: str, fn, *args) -> None:
    """Call one C entry (which launches its kernel on the current stream and
    returns cudaGetLastError()); raise on a refused launch, else count it."""
    import torch

    rc = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        msg = lib().pgm_error_string(rc).decode()
        raise RuntimeError("CUDA kernel %s failed to launch: %s (%d)"
                           % (name, msg, rc))
    LAUNCHES[name] += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_args(kernel: str, *specs) -> None:
    """Raise unless every (tensor, dtype, shape) of ``specs`` is contiguous
    with that dtype and shape: the kernels index raw pointers."""
    for t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError("%s: expected contiguous %s %s, got %s %s"
                             % (kernel, dtype, tuple(shape), t.dtype,
                                tuple(t.shape)))
