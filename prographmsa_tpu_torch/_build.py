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
A C entry that launches two kernels (``pgm_exact_s``: K1 then K2) counts
one launch of each.
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
SOURCES = ("scores.cu", "fill.cu", "chase.cu", "nw.cu", "pair_stats.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

KERNELS = ("s_prep", "s", "fill", "chase", "nw", "pair_pack", "pair_stats")
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(_DIR, ".build", "pgm_kernels-%s.so" % h.hexdigest()[:16])


def build() -> str:
    """Compile the kernels unless the hashed library exists; returns its path.
    One nvcc per source, all started together, then one link.  Records the
    build seconds and nvcc's register report in ``build_info``."""
    so = so_path()
    if os.path.exists(so):
        build_info.setdefault("seconds", 0.0)
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    nvcc = _nvcc()
    tag = "%s.tmp.%d" % (so, os.getpid())
    t0 = time.perf_counter()
    objs = ["%s.%s.o" % (tag, src) for src in SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(_CSRC, src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(SOURCES, objs)]
    try:
        logs = [p.communicate(timeout=600) for p in procs]
        for src, p, (_, err) in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError("nvcc failed on %s (%d):\n%s"
                                   % (src, p.returncode, err[-4000:]))
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tag, *objs],
                              capture_output=True, text=True, timeout=600)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed (%d):\n%s"
                               % (link.returncode, link.stderr[-4000:]))
        os.replace(tag, so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["ptxas"] = "".join(err for _, err in logs)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        L = ctypes.CDLL(build())
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L.pgm_s_prep.argtypes = [p, p, p] + [i] * 6 + [p, p, p]
        L.pgm_s.argtypes = [p] * 7 + [i] * 5 + [f] * 3 + [i] * 2 + [p, p]
        L.pgm_exact_s.argtypes = ([p] * 7 + [i] * 5 + [f] * 3 + [i] * 6
                                  + [p, p, p])
        L.pgm_q_check.argtypes = [f, f, p, p]
        L.pgm_empty.argtypes = [p]
        L.pgm_fill.argtypes = [p] * 7 + [i] * 11 + [p] * 12
        L.pgm_fill_max_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
        L.pgm_fill_max_clusters.restype = i
        L.pgm_chase.argtypes = [p] * 14 + [i] * 10 + [p, p, p]
        L.pgm_chase_latency.argtypes = [p, i, i, i, p, p]
        L.pgm_nw.argtypes = [p] * 5 + [i] * 12 + [p] * 4
        L.pgm_dpx_rate.argtypes = [i, i, i, p, p]
        L.pgm_pair_pack.argtypes = [p] * 2 + [i] * 3 + [p] * 4
        L.pgm_pair_stats.argtypes = [p] * 5 + [i] * 5 + [p] * 3
        for fn in (L.pgm_s_prep, L.pgm_s, L.pgm_exact_s, L.pgm_q_check,
                   L.pgm_empty, L.pgm_fill, L.pgm_chase,
                   L.pgm_chase_latency, L.pgm_nw, L.pgm_dpx_rate,
                   L.pgm_pair_pack, L.pgm_pair_stats):
            fn.restype = ctypes.c_int
        L.pgm_error_string.argtypes = [i]
        L.pgm_error_string.restype = ctypes.c_char_p
        _lib = L
        return L


def _current_stream() -> int:
    """The current CUDA stream's handle.  ``torch.cuda.current_stream()``
    builds a Stream object on every call (about 5 us on an H100 host, as
    much as a kernel launch); the raw query is used where torch has it."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def launch(names, fn, *args) -> None:
    """Call one C entry (which launches its kernels on the current stream and
    returns cudaGetLastError()); raise on a refused launch, else count one
    launch of each kernel in ``names`` (a kernel's name, or a tuple of them;
    an empty tuple for an entry that is no kernel of the port)."""
    rc = fn(*args, _current_stream())
    if rc != 0:
        msg = lib().pgm_error_string(rc).decode()
        raise RuntimeError("CUDA kernel %s failed to launch: %s (%d)"
                           % (names, msg, rc))
    for name in ((names,) if isinstance(names, str) else names):
        LAUNCHES[name] += 1


def ptr(t) -> int | None:
    """The tensor's address (``None`` is the null pointer), as the
    ``c_void_p`` argument types take it."""
    return None if t is None else t.data_ptr()


def check_args(kernel: str, *specs) -> None:
    """Raise unless every (tensor, dtype, shape) of ``specs`` is contiguous
    with that dtype and shape: the kernels index raw pointers."""
    for t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError("%s: expected contiguous %s %s, got %s %s"
                             % (kernel, dtype, tuple(shape), t.dtype,
                                tuple(t.shape)))
