"""Native host engine bindings (ctypes, no pybind11 dependency).

The port's own copy of prographmsa_tpu/native: compiles graphcore.cpp on
first use into the port's gitignored ``.build/`` directory (beside the CUDA
kernels' library; never the other package's cache) and exposes typed
wrappers.  The native tier is optional: callers
must handle ``lib() is None`` (no compiler / PROGRAPHMSA_NATIVE=0) by using
the numpy reference implementations, which are bit-identical.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "graphcore.cpp")
_lock = threading.Lock()
_lib = None
_tried = False

_CFLAGS = ["-O3", "-fPIC", "-shared", "-ffp-contract=off", "-std=c++17",
           "-march=native"]


def _so_path() -> str:
    """Build artifact path in a gitignored cache dir, keyed by a content
    hash of the source + flags (a checkout never carries a stale or
    wrong-arch binary; mtimes are irrelevant)."""
    import hashlib
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_CFLAGS).encode()).hexdigest()
    cache = os.environ.get("PROGRAPHMSA_TORCH_NATIVE_CACHE",
                           os.path.join(os.path.dirname(_DIR), ".build"))
    return os.path.join(cache, "graphcore-torch-%s.so" % h[:16])


_SO = None  # resolved lazily in lib()


def _build(so: str) -> bool:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = so + ".tmp.%d" % os.getpid()
    cmd = ["g++", *_CFLAGS, "-o", tmp, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def lib():
    """The loaded graphcore library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PROGRAPHMSA_NATIVE", "1") == "0":
            return None
        try:
            global _SO
            _SO = _so_path()
            if not os.path.exists(_SO) and not _build(_SO):
                return None
            L = ctypes.CDLL(_SO)
        except OSError:
            return None

        i32 = ctypes.c_int32
        f32 = ctypes.c_float
        # Arrays cross as raw data pointers (wrappers pass arr.ctypes.data
        # of freshly-made contiguous arrays) — ndpointer's per-call
        # flag/dtype validation was ~20% of small-kernel call cost.
        pi32 = ctypes.c_void_p
        pi64 = ctypes.c_void_p
        pf32 = ctypes.c_void_p
        pf32_1 = ctypes.POINTER(ctypes.c_float)

        L.gc_fill_dp.restype = None
        L.gc_fill_dp.argtypes = [i32, i32, i32, i32, pi32, pf32, pi32, pf32,
                                 pf32, f32, f32, f32, f32, f32, f32, f32,
                                 pf32, pf32, pf32, pf32, pf32_1]
        L.gc_backtrack.restype = i32
        L.gc_backtrack.argtypes = [i32, i32, i32, i32, pi32, pf32, pi32, pf32,
                                   pf32, pf32, pf32, pf32, pf32, f32, f32,
                                   f32, f32, f32, f32, pi32, pi32]
        L.gc_nw_batch.restype = None
        L.gc_nw_batch.argtypes = [i32, i32, i32, pi32, pi32, pi32, pi32,
                                  pi32, i32, i32, i32, i32, i32, pi64, pi32]
        L.gc_precompute_scores.restype = None
        L.gc_precompute_scores.argtypes = [i32, i32, i32, pf32, pf32, pf32,
                                           pf32, f32, pf32]
        L.gc_average_alignment_length.restype = ctypes.c_double
        L.gc_average_alignment_length.argtypes = [i32, i32, pi32, pf32]
        pu8 = ctypes.c_void_p
        pi32_1 = ctypes.POINTER(ctypes.c_int32)
        L.gc_clean_graph.restype = i32
        L.gc_clean_graph.argtypes = [i32, i32, pi32, pf32, pu8, pi32, f32,
                                     pi32, pi32, pi32, pf32, pi32_1,
                                     pi32, pi32, pi32, pi32_1]
        pf64 = ctypes.c_void_p
        pvoid = ctypes.c_void_p
        L.gc_unify.restype = i32
        L.gc_unify.argtypes = [pvoid, pvoid, i32, i32, i32, i32, pi32, pi32,
                               pf64, pf64, pf64, pf64, pf64, pi32, pi32,
                               pu8]
        L.gc_merge_edges.restype = None
        L.gc_merge_edges.argtypes = [i32, pi32, pi32, pu8,
                                     i32, i32, pi32, pf32, pu8, pi32, pi32,
                                     i32, i32, pi32, pf32, pu8, pi32, pi32,
                                     f32, f32, i32,
                                     pi32, pi32, pf32, pi32_1,
                                     pi32, pi32, pi32, pi32_1]
        L.gc_edge_span.restype = i32
        L.gc_edge_span.argtypes = [i32, i32, pi32, i32, pi32]
        L.gc_align_node.restype = i32
        L.gc_align_node.argtypes = [i32, i32, i32, i32, i32,
                                    pi32, pf32, pi32, pf32,
                                    pf32, pf32, pf32, pf32, f32,
                                    f32, f32, f32, f32, f32, f32, f32,
                                    pi32, pi32, pf32_1]
        L.gc_merge_node_begin.restype = i32
        L.gc_merge_node_begin.argtypes = [i32, pi32, pi32, pu8,
                                          i32, i32, pi32, pf32, pu8, pi32,
                                          i32, i32, pi32, pf32, pu8, pi32,
                                          f32, f32, i32]
        L.gc_merge_node_finish.restype = None
        L.gc_merge_node_finish.argtypes = [i32, i32, pi32, pf32, pu8, pi32]
        L.gc_pad_edges.restype = None
        L.gc_pad_edges.argtypes = [i32, i32, i32, pi32, pi32, pf32,
                                   i32, pi32, pi32, pi32,
                                   pi32, pf32, pu8, pi32]
        _lib = L
        return _lib


def available() -> bool:
    return lib() is not None


# ----------------------------------------------------------------------
# BLAS handles for gc_unify: the evolved-profile matvecs and column norms
# must be bit-identical to numpy's `P @ x` / `np.linalg.norm`, so we hand
# the C++ kernel raw pointers to the *same* cblas_dgemv / cblas_ddot inside
# numpy's own BLAS shared object — and prove bitwise equality on random
# data before enabling it (any mismatch disables the native unify; callers
# fall back to the numpy loop).
_blas = None
_blas_tried = False


def _resolve_blas():
    import glob

    np_dir = os.path.dirname(np.__file__)
    cands = (glob.glob(os.path.join(np_dir, "..", "numpy.libs", "*.so*"))
             + glob.glob(os.path.join(np_dir, ".libs", "*.so*")))
    for path in cands:
        base = os.path.basename(path)
        if "blas" not in base.lower() and "lapack" not in base.lower():
            continue
        try:
            B = ctypes.CDLL(path)
        except OSError:
            continue
        for gemv_name, ddot_name, blas64 in (
                ("scipy_cblas_dgemv64_", "scipy_cblas_ddot64_", 1),
                ("cblas_dgemv64_", "cblas_ddot64_", 1),
                ("cblas_dgemv", "cblas_ddot", 0)):
            gemv = getattr(B, gemv_name, None)
            ddot = getattr(B, ddot_name, None)
            if gemv is None or ddot is None:
                continue
            bint = ctypes.c_int64 if blas64 else ctypes.c_int32
            pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            gemv.restype = None
            gemv.argtypes = [ctypes.c_int32, ctypes.c_int32, bint, bint,
                             ctypes.c_double, pd, bint, pd, bint,
                             ctypes.c_double, pd, bint]
            ddot.restype = ctypes.c_double
            ddot.argtypes = [bint, pd, bint, pd, bint]
            # bitwise self-test vs numpy
            rng = np.random.default_rng(12345)
            ok = True
            for dim in (4, 20, 64):
                for _ in range(8):
                    P = rng.random((dim, dim))
                    x = rng.random(dim)
                    y = np.zeros(dim)
                    gemv(101, 111, dim, dim, 1.0, P, dim, x, 1, 0.0, y, 1)
                    if not np.array_equal(y, P @ x):
                        ok = False
                    if np.float64(np.sqrt(ddot(dim, x, 1, x, 1))) \
                            != np.linalg.norm(x):
                        ok = False
            if not ok:
                continue
            return (ctypes.cast(gemv, ctypes.c_void_p),
                    ctypes.cast(ddot, ctypes.c_void_p), blas64, B)
    return None


def _blas_ptrs():
    global _blas, _blas_tried
    if _blas is not None or _blas_tried:
        return _blas
    with _lock:
        if _blas is not None or _blas_tried:
            return _blas
        _blas_tried = True
        try:
            _blas = _resolve_blas()
        except Exception:
            _blas = None
        return _blas


def unify_native(mode, mapping1, mapping2, sites1, sites2, P1, P2):
    """Native _unify (+ the merge-mode model2.P fixup): returns
    (nodes [n,dim] float64, m1, m2, matched) or None when unavailable.
    mode 0 = merge_graphs, 1 = merge_graphs_incremental."""
    L = lib()
    if L is None:
        return None
    blas = _blas_ptrs()
    if blas is None:
        return None
    gemv, ddot, blas64, _ = blas
    dim = sites1.shape[1]
    map1 = np.asarray(mapping1, dtype=np.int32)
    map2 = np.asarray(mapping2, dtype=np.int32)
    cap = sites1.shape[0] + sites2.shape[0] + 2
    nodes = np.empty((cap, dim), dtype=np.float64)
    m1 = np.empty(cap, dtype=np.int32)
    m2 = np.empty(cap, dtype=np.int32)
    matched = np.empty(cap, dtype=np.uint8)
    s1 = np.ascontiguousarray(sites1, dtype=np.float64)
    s2 = np.ascontiguousarray(sites2, dtype=np.float64)
    p1 = np.ascontiguousarray(P1, dtype=np.float64)
    p2 = np.ascontiguousarray(P2, dtype=np.float64)
    n = L.gc_unify(gemv, ddot, blas64, dim, mode, map1.shape[0],
                   _d(map1), _d(map2), _d(s1), _d(s2), _d(p1), _d(p2),
                   _d(nodes), _d(m1), _d(m2), _d(matched))
    if n < 0:
        raise AssertionError("error in mapping")
    return nodes[:n], m1[:n], m2[:n], matched[:n]


def pad_edges_native(n, e_to, e_from, e_cost, r_to, r_from, r_units):
    """Native padded-array packing of (to, from)-sorted edge arrays —
    drop-in for graph.padded_from_edges on the merge hot path.  Returns
    (idx, cost, isrep, units) or None when unavailable; raises on unsorted
    input like the numpy version's asserts."""
    L = lib()
    if L is None:
        return None
    et = np.ascontiguousarray(e_to, dtype=np.int32)
    ef = np.ascontiguousarray(e_from, dtype=np.int32)
    ec = np.ascontiguousarray(e_cost, dtype=np.float32)
    rt = np.ascontiguousarray(r_to, dtype=np.int32)
    rf = np.ascontiguousarray(r_from, dtype=np.int32)
    ru = np.ascontiguousarray(r_units, dtype=np.int32)
    E = L.gc_edge_span(n, len(et), _d(et), len(rt), _d(rt))
    if E < 0:
        raise AssertionError("edges must be sorted by 'to'")
    idx = np.empty((n, E), dtype=np.int32)
    cost = np.empty((n, E), dtype=np.float32)
    isrep = np.empty((n, E), dtype=bool)
    units = np.empty((n, E), dtype=np.int32)
    L.gc_pad_edges(n, E, len(et), _d(et), _d(ef), _d(ec),
                   len(rt), _d(rt), _d(rf), _d(ru),
                   _d(idx), _d(cost), _d(isrep), _d(units))
    return idx, cost, isrep, units


def _d(a):
    """Raw data pointer of a C-contiguous array (argtype c_void_p).

    NEVER call as ``_d(np.ascontiguousarray(x))`` or with any other inline
    temporary: the pointer outlives the temporary and becomes a silent
    use-after-free.  Hoist the array into a local that stays live across
    the native call.

    ``from_buffer`` is ~3x cheaper than ``a.ctypes.data`` AND enforces the
    C-contiguity/writability contract itself (TypeError on strided or
    Fortran layouts), replacing the previous assert."""
    if a.nbytes == 0:           # from_buffer rejects empty buffers; the
        return a.ctypes.data    # kernels never dereference 0-count args
    if not a.flags.writeable:   # read-only arrays (e.g. np.frombuffer) are
        return a.ctypes.data    # legitimate const kernel arguments
    return ctypes.addressof(ctypes.c_char.from_buffer(a))


def n_threads() -> int:
    env = os.environ.get("PROGRAPHMSA_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


# ----------------------------------------------------------------------
def fill_dp_native(g1, g2, S, scores):
    """Native gc_fill_dp -> DPMatrices, bit-identical to align/dp.fill_dp.
    Returns None when the library is unavailable."""
    L = lib()
    if L is None:
        return None
    from ..align.dp import DPMatrices, _padded_with_repeat_costs

    idx1, cost1, _ = _padded_with_repeat_costs(g1, scores)
    idx2, cost2, _ = _padded_with_repeat_costs(g2, scores)
    n1, n2 = g1.size, g2.size
    M = np.empty((n1, n2), dtype=np.float32)
    X = np.empty((n1, n2), dtype=np.float32)
    Y = np.empty((n1, n2), dtype=np.float32)
    W = np.empty((n1, n2), dtype=np.float32)
    Sf = np.ascontiguousarray(S, dtype=np.float32)
    wend = ctypes.c_float()
    # idx/cost come from Graph.padded() / np.where — always fresh
    # C-contiguous arrays, so their data pointers are passed directly.
    L.gc_fill_dp(n1, n2, idx1.shape[1], idx2.shape[1],
                 _d(idx1), _d(cost1), _d(idx2), _d(cost2),
                 _d(Sf), np.float32(scores.gap_extend),
                 np.float32(scores.gap_init),
                 np.float32(scores.start_gap), np.float32(scores.start_init),
                 np.float32(scores.end_match), np.float32(scores.end_gap),
                 np.float32(scores.end_skip), _d(M), _d(X), _d(Y), _d(W),
                 ctypes.byref(wend))
    return DPMatrices(M=M, X=X, Y=Y, W=W, S=Sf,
                      Wend=np.float32(wend.value))


def backtrack_native(g1, g2, dp, scores):
    """Native gc_backtrack -> AlignmentResult for repeat-free graph pairs;
    None when unavailable/not applicable (caller falls back to Python)."""
    L = lib()
    if L is None:
        return None
    if g1.padded()[2].any() or g2.padded()[2].any():
        return None
    from ..align.dp import _padded_with_repeat_costs
    from ..align.backtrack import AlignmentResult

    idx1, cost1, _ = _padded_with_repeat_costs(g1, scores)
    idx2, cost2, _ = _padded_with_repeat_costs(g2, scores)
    n1, n2 = g1.size, g2.size
    cap = n1 + n2 + 4
    map1 = np.empty(cap, dtype=np.int32)
    map2 = np.empty(cap, dtype=np.int32)
    # dp.S/M/X/Y/W are the contiguous outputs of fill_dp_native
    n = L.gc_backtrack(n1, n2, idx1.shape[1], idx2.shape[1],
                       _d(idx1), _d(cost1), _d(idx2), _d(cost2),
                       _d(dp.S), _d(dp.M), _d(dp.X), _d(dp.Y), _d(dp.W),
                       np.float32(dp.Wend), np.float32(scores.gap_extend),
                       np.float32(scores.gap_init),
                       np.float32(scores.end_match),
                       np.float32(scores.end_gap),
                       np.float32(scores.end_skip), _d(map1), _d(map2))
    if n < 0:
        return None
    return AlignmentResult(score=dp.Wend, n_tr_indels=0,
                           mapping1=list(map1[:n][::-1]),
                           mapping2=list(map2[:n][::-1]))


def align_node_native(g1, g2, model, scores):
    """Fused gc_align_node: S + fill + backtrack in one native call with
    thread-local scratch (no per-stage numpy matrix roundtrips).  Only for
    repeat-free graph pairs; None when unavailable/not applicable — the
    caller falls back to the staged path, which is bit-identical."""
    L = lib()
    if L is None:
        return None
    if g1.padded()[2].any() or g2.padded()[2].any():
        return None
    from ..align.dp import _padded_with_repeat_costs
    from ..align.backtrack import AlignmentResult

    idx1, cost1, _ = _padded_with_repeat_costs(g1, scores)
    idx2, cost2, _ = _padded_with_repeat_costs(g2, scores)
    n1, n2 = g1.size, g2.size
    g1s = np.ascontiguousarray(g1.sites, dtype=np.float32)
    g2s = np.ascontiguousarray(g2.sites, dtype=np.float32)
    M = np.ascontiguousarray(model.M, dtype=np.float32)
    pi = np.ascontiguousarray(model.pi, dtype=np.float32)
    cap = n1 + n2 + 4
    map1 = np.empty(cap, dtype=np.int32)
    map2 = np.empty(cap, dtype=np.int32)
    wend = ctypes.c_float()
    n = L.gc_align_node(n1, n2, M.shape[0], idx1.shape[1], idx2.shape[1],
                        _d(idx1), _d(cost1), _d(idx2), _d(cost2),
                        _d(g1s), _d(g2s), _d(M), _d(pi),
                        np.float32(scores.match_init),
                        np.float32(scores.gap_extend),
                        np.float32(scores.gap_init),
                        np.float32(scores.start_gap),
                        np.float32(scores.start_init),
                        np.float32(scores.end_match),
                        np.float32(scores.end_gap),
                        np.float32(scores.end_skip),
                        _d(map1), _d(map2), ctypes.byref(wend))
    if n < 0:
        return None
    return AlignmentResult(score=np.float32(wend.value), n_tr_indels=0,
                           mapping1=list(map1[:n][::-1]),
                           mapping2=list(map2[:n][::-1]))


def precompute_scores_native(g1, g2, model, match_init):
    """Native gc_precompute_scores -> S [n1, n2] float32, bit-identical to
    align/scores.precompute_scores.  None when unavailable."""
    L = lib()
    if L is None:
        return None
    g1s = np.ascontiguousarray(g1.sites, dtype=np.float32)
    g2s = np.ascontiguousarray(g2.sites, dtype=np.float32)
    M = np.ascontiguousarray(model.M, dtype=np.float32)
    pi = np.ascontiguousarray(model.pi, dtype=np.float32)
    n1, n2 = g1.size, g2.size
    S = np.empty((n1, n2), dtype=np.float32)
    L.gc_precompute_scores(n1, n2, M.shape[0], _d(g1s), _d(g2s), _d(M),
                           _d(pi), np.float32(match_init), _d(S))
    return S


def average_alignment_length_native(graph):
    """Native gc_average_alignment_length (free normal edges only; repeat
    edges never count under (inf, inf)).  None when unavailable."""
    L = lib()
    if L is None:
        return None
    n = graph.size
    if n == 0:
        return 0.0
    # padded() keeps +inf cost on repeat slots, which gc_average_alignment_
    # length already treats as "no edge" — so the cache is reusable as-is.
    idx, cost, _, _ = graph.padded()
    return float(L.gc_average_alignment_length(n, idx.shape[1],
                                                _d(idx), _d(cost)))


def clean_graph_native(graph, repeat_ext):
    """Native gc_clean_graph -> (mapping [n] int32, new_dim, edge arrays,
    repeat arrays), identical to the numpy marking/compaction.  None when
    unavailable; raises AssertionError on the reachability invariant like
    the Python path."""
    L = lib()
    if L is None:
        return None
    idx, cost, isrep, units = graph.padded()
    n, E = idx.shape
    mapping = np.empty(n, dtype=np.int32)
    cap = n * E
    e_to = np.empty(cap, dtype=np.int32)
    e_from = np.empty(cap, dtype=np.int32)
    e_cost = np.empty(cap, dtype=np.float32)
    r_to = np.empty(cap, dtype=np.int32)
    r_from = np.empty(cap, dtype=np.int32)
    r_units = np.empty(cap, dtype=np.int32)
    ne = ctypes.c_int32()
    nr = ctypes.c_int32()
    # padded() arrays are contiguous; bool has uint8 memory layout
    new_dim = L.gc_clean_graph(
        n, E, _d(idx), _d(cost), _d(isrep), _d(units),
        np.float32(repeat_ext),
        _d(mapping), _d(e_to), _d(e_from), _d(e_cost), ctypes.byref(ne),
        _d(r_to), _d(r_from), _d(r_units), ctypes.byref(nr))
    assert new_dim >= 0, "clean_graph reachability invariant"
    ne, nr = ne.value, nr.value
    return (mapping, new_dim, e_to[:ne], e_from[:ne], e_cost[:ne],
            r_to[:nr], r_from[:nr], r_units[:nr])


def merge_edges_native(m1, m2, matched, g1, inv1, g2, inv2,
                       up1, up2, with_penalty):
    """Native gc_merge_edges -> (e_to, e_from, e_cost_quantized, r_to,
    r_from, r_units) in (to, from)-sorted order, identical to the Python
    edge bookkeeping + from_maps quantization.  None when unavailable."""
    L = lib()
    if L is None:
        return None
    n_nodes = len(m1)
    m1a = np.asarray(m1, dtype=np.int32)
    m2a = np.asarray(m2, dtype=np.int32)
    ma = np.asarray(matched, dtype=np.uint8)
    idx1, cost1, isrep1, units1 = g1.padded()
    idx2, cost2, isrep2, units2 = g2.padded()
    cap = (n_nodes * 4 + g1.size * idx1.shape[1] + g2.size * idx2.shape[1]
           + 16)
    e_to = np.empty(cap, dtype=np.int32)
    e_from = np.empty(cap, dtype=np.int32)
    e_cost = np.empty(cap, dtype=np.float32)
    r_to = np.empty(cap, dtype=np.int32)
    r_from = np.empty(cap, dtype=np.int32)
    r_units = np.empty(cap, dtype=np.int32)
    ne = ctypes.c_int32()
    nr = ctypes.c_int32()
    inv1a = np.ascontiguousarray(inv1, dtype=np.int32)
    inv2a = np.ascontiguousarray(inv2, dtype=np.int32)
    L.gc_merge_edges(
        n_nodes, _d(m1a), _d(m2a), _d(ma),
        g1.size, idx1.shape[1], _d(idx1), _d(cost1), _d(isrep1), _d(units1),
        _d(inv1a),
        g2.size, idx2.shape[1], _d(idx2), _d(cost2), _d(isrep2), _d(units2),
        _d(inv2a),
        np.float32(up1), np.float32(up2), 1 if with_penalty else 0,
        _d(e_to), _d(e_from), _d(e_cost), ctypes.byref(ne),
        _d(r_to), _d(r_from), _d(r_units), ctypes.byref(nr))
    ne, nr = ne.value, nr.value
    return (e_to[:ne], e_from[:ne], e_cost[:ne],
            r_to[:nr], r_from[:nr], r_units[:nr])


def merge_node_native(m1, m2, matched, g1, g2, up1, up2, with_penalty):
    """Fused gc_merge_node_begin/finish: inverse mappings + edge
    construction + padded packing with native thread-local staging (no
    Python-side capacity arrays; one eighth the ctypes crossings of the
    staged merge_edges_native + pad_edges_native path).  Returns the
    padded (idx, cost, isrep, units) arrays, or None when unavailable."""
    L = lib()
    if L is None:
        return None
    n_nodes = len(m1)
    m1a = np.asarray(m1, dtype=np.int32)
    m2a = np.asarray(m2, dtype=np.int32)
    ma = np.asarray(matched, dtype=np.uint8)
    idx1, cost1, isrep1, units1 = g1.padded()
    idx2, cost2, isrep2, units2 = g2.padded()
    E = L.gc_merge_node_begin(
        n_nodes, _d(m1a), _d(m2a), _d(ma),
        g1.size, idx1.shape[1], _d(idx1), _d(cost1), _d(isrep1), _d(units1),
        g2.size, idx2.shape[1], _d(idx2), _d(cost2), _d(isrep2), _d(units2),
        np.float32(up1), np.float32(up2), 1 if with_penalty else 0)
    idx = np.empty((n_nodes, E), dtype=np.int32)
    cost = np.empty((n_nodes, E), dtype=np.float32)
    isrep = np.empty((n_nodes, E), dtype=bool)
    units = np.empty((n_nodes, E), dtype=np.int32)
    L.gc_merge_node_finish(n_nodes, E, _d(idx), _d(cost), _d(isrep),
                           _d(units))
    return idx, cost, isrep, units


def nw_counts_native(s1b, s2b, l1, l2, scoring, go, ge, dim):
    """Native threaded NW fill+backtrack; (counts [B,dim,dim] i64, gaps [B]).
    None when unavailable."""
    L = lib()
    if L is None:
        return None
    B = s1b.shape[0]
    counts = np.zeros((B, dim, dim), dtype=np.int64)
    gaps = np.zeros(B, dtype=np.int32)
    s1a = np.ascontiguousarray(s1b, dtype=np.int32)
    l1a = np.ascontiguousarray(l1, dtype=np.int32)
    s2a = np.ascontiguousarray(s2b, dtype=np.int32)
    l2a = np.ascontiguousarray(l2, dtype=np.int32)
    sca = np.ascontiguousarray(scoring, dtype=np.int32)
    L.gc_nw_batch(B, s1b.shape[1], s2b.shape[1],
                  _d(s1a), _d(l1a), _d(s2a), _d(l2a), _d(sca),
                  scoring.shape[0], dim, go, ge, n_threads(),
                  _d(counts), _d(gaps))
    return counts, gaps
