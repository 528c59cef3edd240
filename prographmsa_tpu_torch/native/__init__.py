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
        L.gc_angle_gram.restype = None
        L.gc_angle_gram.argtypes = [i32, i32, pf64, pf64, pf64]
        L.gc_redux_sum.restype = None
        L.gc_redux_sum.argtypes = [i32, i32, pf64, i32, pf64]
        L.gc_bionj.restype = i32
        L.gc_bionj.argtypes = [i32, pf64, pf64, i32, pi32, pi32, pf64, pf64,
                               i32]
        L.gc_bionj_probe.restype = i32
        L.gc_bionj_probe.argtypes = []
        i64 = ctypes.c_int64
        L.gc_pair_stats.restype = i32
        L.gc_pair_stats.argtypes = [i32, i32, pi32, pu8, i64, pi32, pi32, i32,
                                    i32, pi64, pi64, i32]
        L.gc_offset_slots.restype = i32
        L.gc_offset_slots.argtypes = [i32, i32, pi32, pu8, i32, pi32, pi32_1]
        L.gc_offset_costs.restype = i32
        L.gc_offset_costs.argtypes = [i32, i32, pi32, pf32, pu8, pi32, f32,
                                      f32, i32, i32, pi32, i32, f32, pf32,
                                      pu8]
        L.gc_pack_planes.restype = None
        L.gc_pack_planes.argtypes = [i32, i32, i32, i32, i32, pi32, pi64, f32,
                                     pf32, pf32, pf32, pf32, pu8, pu8, pi64,
                                     i32]
        pv = ctypes.c_void_p
        L.gc_clean_batch_begin.restype = pv
        L.gc_clean_batch_begin.argtypes = [i32, pi32, pi64, f32, pi32, i32]
        L.gc_clean_batch_finish.restype = i32
        L.gc_clean_batch_finish.argtypes = [pv, pi32, pi64, i32]
        L.gc_align_batch_begin.restype = pv
        L.gc_align_batch_begin.argtypes = [i32, pi32, pi64, pf32, pi32, pf32,
                                           i32]
        L.gc_align_batch_finish.restype = None
        L.gc_align_batch_finish.argtypes = [pv, pi32, pi32, pi32]
        L.gc_merge_batch_begin.restype = pv
        L.gc_merge_batch_begin.argtypes = [i32, pi32, pi64, pf32, pvoid,
                                           pvoid, i32, pi32, i32]
        L.gc_merge_batch_finish.restype = i32
        L.gc_merge_batch_finish.argtypes = [pv, pi32, pi64, i32]
        L.gc_batch_free.restype = None
        L.gc_batch_free.argtypes = [pv]
        L.gc_batch_probe.restype = None
        L.gc_batch_probe.argtypes = [ctypes.c_int64, pi32]
        L.gc_extend_batch.restype = None
        L.gc_extend_batch.argtypes = [i32, pi32, pi64, pi32, pi32, pi64,
                                      ctypes.c_int16, pi32, i32]
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


def angle_gram_native(counts, inv_norm):
    """Native gc_angle_gram: the angle distances' Gram G [n, n] of the
    k-mer counts [n, K] with each row scaled by ``inv_norm``, bit-identical
    to distances/angle.py's cumulative sum over k.  None when
    unavailable."""
    L = lib()
    if L is None:
        return None
    c = np.ascontiguousarray(counts, dtype=np.float64)
    inv = np.ascontiguousarray(inv_norm, dtype=np.float64)
    n, k = c.shape
    G = np.empty((n, n), dtype=np.float64)
    L.gc_angle_gram(n, k, _d(c), _d(inv), _d(G))
    return G


def pair_stats_native(vmat, gmat, pi, pj, dim, count_bound):
    """Native gc_pair_stats: the prealigned statistics of the row pairs
    (pi, pj) of the alignment vmat / gmat [n, L] -> (counts
    [P, max(dim, cb), max(dim, cb)] int64, gap openings [P] int64),
    bit-identical to distances/prealigned.py's numpy batch.  Values cross
    as int32 and gap flags as uint8 (nonzero: a gap): an int32 ``vmat``
    and a bool or uint8 ``gmat``, C-contiguous, cross as they are (the
    prealigned stage makes them so once); other types are converted here,
    values outside [0, count_bound) to -1, which the counts skip as they
    skip the value.
    Raises IndexError for a row index outside [0, n).  None when the
    library is unavailable."""
    L = lib()
    if L is None:
        return None
    cb = int(count_bound)
    if vmat.dtype == np.int32 or (vmat.dtype.kind in "iu"
                                  and vmat.dtype.itemsize < 4):
        v = np.ascontiguousarray(vmat, dtype=np.int32)
    else:
        v = np.where((vmat >= 0) & (vmat < cb), vmat, -1).astype(np.int32)
    g = gmat if gmat.dtype in (np.bool_, np.uint8) else gmat != 0
    g = np.ascontiguousarray(g).view(np.uint8)
    a = np.ascontiguousarray(pi, dtype=np.int32)
    b = np.ascontiguousarray(pj, dtype=np.int32)
    n, width = v.shape
    P, d = len(a), max(int(dim), cb)
    counts = np.empty((P, d, d), dtype=np.int64)
    gaps = np.empty(P, dtype=np.int64)
    if L.gc_pair_stats(n, width, _d(v), _d(g), P, _d(a), _d(b), cb, d,
                       _d(counts), _d(gaps), n_threads()) < 0:
        raise IndexError("a pair's row index lies outside [0, %d)" % n)
    return counts, gaps


def offset_costs_native(padded, ri, re, max_offsets, cap_value=None):
    """Native gc_offset_slots + gc_offset_costs: one graph's slot tables
    for the device DP batch from its padded arrays (``graph.padded()``)
    and the float32 repeat scores ``ri``, ``re`` -> (offsets [m] int32,
    C [n, m] float32, rep [n, m] bool), bit-identical to
    align/slots.py's numpy body; with ``cap_value`` every non-finite cell
    of C is that value (slots.inf_to_cap).  None when the graph needs more
    than ``max_offsets`` slots.  Raises ValueError on padded arrays of
    unequal shapes and RuntimeError when the two calls disagree on the
    slots.  The library must be loaded."""
    L = lib()
    idx, cost, isrep, units = padded
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    cost = np.ascontiguousarray(cost, dtype=np.float32)
    isrep = np.ascontiguousarray(isrep, dtype=np.bool_)
    units = np.ascontiguousarray(units, dtype=np.int32)
    if idx.ndim != 2 or not idx.shape == cost.shape == isrep.shape == \
            units.shape:
        raise ValueError("offset_costs_native: padded arrays of shapes %s"
                         % [a.shape for a in (idx, cost, isrep, units)])
    n, E = idx.shape
    offsets = np.empty(max(1, min(max_offsets, n * E)), dtype=np.int32)
    n_rep = ctypes.c_int32()
    p_idx, p_isrep, p_offsets = _d(idx), _d(isrep), _d(offsets)
    count = L.gc_offset_slots(n, E, p_idx, p_isrep, max_offsets, p_offsets,
                              ctypes.byref(n_rep))
    if count < 0:
        return None
    m = max(1, count)
    if count == 0:
        offsets[0] = 1
    C = np.empty((n, m), dtype=np.float32)
    rep = np.empty((n, m), dtype=np.bool_)
    got = L.gc_offset_costs(n, E, p_idx, _d(cost), p_isrep, _d(units), ri,
                            re, count, n_rep.value, p_offsets,
                            cap_value is not None,
                            0.0 if cap_value is None else cap_value,
                            _d(C), _d(rep))
    if got != count:
        raise RuntimeError("gc_offset_costs found %d slots where "
                           "gc_offset_slots found %d" % (got, count))
    return offsets[:m], C, rep


def pack_planes_native(arrays, dim, n1max, n2max, opmax, cap_value):
    """Native gc_pack_planes: the large planes of one launch of the device
    DP batch, threaded over pairs at ``n_threads()``.  ``arrays`` holds per
    pair (sites1 [a1, dim], sites2 [a2, dim], C1 [a1, k1], C2 [a2, k2],
    rep1 [a1, k1], rep2 [a2, k2]), with a1 <= n1max, a2 <= n2max, k1, k2
    <= opmax; they cross as C-contiguous float64 sites, float32 costs and
    bool flags, converted here where they are not.  Returns (g1T
    [B, dim, n1max] float32, g2T, C1T [B, opmax, n1max] float32, C2T, R1T
    [B, opmax, n1max] uint8, R2T, finite [B, 2] int64: each C's entries
    below ``cap_value``), bit-identical to graph_dp_cuda._planes_numpy.
    Raises ValueError on shapes that do not fit.  The library must be
    loaded."""
    L = lib()
    B = len(arrays)
    sides = np.empty((B, 4), np.int32)
    ptrs = np.empty((B, 6), np.int64)
    types = (np.float64,) * 2 + (np.float32,) * 2 + (np.bool_,) * 2
    # the converted arrays stay referenced here until the call returns
    held = [[np.ascontiguousarray(x, dtype=t) for x, t in zip(a, types)]
            for a in arrays]
    for b, (s1, s2, c1, c2, r1, r2) in enumerate(held):
        if not (all(x.ndim == 2 for x in held[b])
                and s1.shape[1] == s2.shape[1] == dim
                and c1.shape == r1.shape and len(c1) == len(s1) <= n1max
                and c2.shape == r2.shape and len(c2) == len(s2) <= n2max
                and max(c1.shape[1], c2.shape[1]) <= opmax):
            raise ValueError("pack_planes_native: pair %d's shapes %s do "
                             "not fit the launch (%d, %d, %d, %d)"
                             % (b, [x.shape for x in held[b]], dim, n1max,
                                n2max, opmax))
        sides[b] = (len(s1), len(s2), c1.shape[1], c2.shape[1])
        ptrs[b] = [x.ctypes.data for x in held[b]]
    f32 = np.float32
    g1T = np.empty((B, dim, n1max), f32)
    g2T = np.empty((B, dim, n2max), f32)
    C1T = np.empty((B, opmax, n1max), f32)
    C2T = np.empty((B, opmax, n2max), f32)
    R1T = np.empty((B, opmax, n1max), np.uint8)
    R2T = np.empty((B, opmax, n2max), np.uint8)
    finite = np.empty((B, 2), np.int64)
    L.gc_pack_planes(B, dim, n1max, n2max, opmax, _d(sides), _d(ptrs),
                     cap_value, _d(g1T), _d(g2T), _d(C1T), _d(C2T), _d(R1T),
                     _d(R2T), _d(finite), n_threads())
    return g1T, g2T, C1T, C2T, R1T, R2T, finite


def bionj_native(D, V, plan):
    """Native gc_bionj: BioNJ's joins on D and V ([n, n], n > 3) ->
    (joins [n - 3, 2] int32, branch lengths [n - 3, 2] float64, the 3 x 3
    D left), bit-identical to tree/nj.py's loop at any thread count; its
    steps' O(n^2) parts run over up to ``n_threads()`` threads with the
    GIL released (fewer for a small D; ``batch_probe``'s grain applies).
    ``plan`` is the forced (index1, index2) schedule.  None when
    unavailable or when a pair of ``plan`` is no pair of the current rows
    (the numpy loop then meets it)."""
    L = lib()
    if L is None:
        return None
    n = D.shape[0]
    Dc = np.ascontiguousarray(D, dtype=np.float64)
    Vc = np.ascontiguousarray(V, dtype=np.float64)
    pl = np.ascontiguousarray(np.asarray(plan, dtype=np.int32).reshape(-1, 2))
    joins = np.empty((n - 3, 2), dtype=np.int32)
    lens = np.empty((n - 3, 2), dtype=np.float64)
    d_end = np.empty((3, 3), dtype=np.float64)
    if L.gc_bionj(n, _d(Dc), _d(Vc), len(pl), _d(pl), _d(joins), _d(lens),
                  _d(d_end), n_threads()) < 0:
        return None
    return joins, lens, d_end


def bionj_probe() -> int:
    """The most threads ``bionj_native`` ran on since the last probe, the
    count then started anew."""
    return int(lib().gc_bionj_probe())


# ----------------------------------------------------------------------
# A level's host stage in batches (engine/level_driver.py): each call
# takes every item of a level, crosses into the library once and spreads
# the items over ``n_threads()`` threads there, with the GIL released, so
# the Python per item is a few array allocations.  Each item's result is
# that of the per-item wrapper above, bit for bit.  The library must be
# loaded (``batches(options)``); an error inside a batch raises and is
# never retried on another path.


def batches(options) -> bool:
    """Whether the level's host stage runs in native batches: the library
    loaded, BLAS resolved for the merges, and a host engine that takes the
    native kernels (``auto`` or ``native``)."""
    return (getattr(options, "engine", "auto") in ("auto", "native")
            and lib() is not None and _blas_ptrs() is not None)


BATCH_KINDS = ("clean_begin", "clean_finish", "align", "merge_begin",
               "merge_finish", "extend")


def batch_probe(grain=0):
    """The most threads each kind of batch call (BATCH_KINDS) ran on since
    the last probe, as a dict, the count then started anew; from now on
    every batch (and ``bionj_native``) gives a thread ``grain`` units of
    work in place of its own constant (0: its own).  The tests lower the
    grain so that small inputs run the threaded paths."""
    used = np.zeros(len(BATCH_KINDS), np.int32)
    lib().gc_batch_probe(int(grain), _d(used))
    return dict(zip(BATCH_KINDS, used.tolist()))


def _c(a, dtype):
    """``a`` as a C-contiguous array of ``dtype``, converted only where it
    is not one."""
    if a.dtype == dtype and a.flags.c_contiguous:
        return a
    return np.ascontiguousarray(a, dtype=dtype)


def _staged(h, what):
    if not h:
        raise MemoryError("%s: an item could not allocate" % what)
    return h


def clean_batch(graphs, repeat_ext):
    """gc_clean_batch_begin/finish over ``graphs``: per graph None where it
    is a linear chain that cleans to itself (clean_graph's fast path),
    else (sites [m, dim] float64, outmapping [m] int64, idx, cost, isrep,
    units [m, E]), identical to clean_graph's native branch.  Raises
    AssertionError on the reachability invariant, as clean_graph does."""
    L = lib()
    B = len(graphs)
    dims = np.empty((B, 3), np.int32)
    ptrs = np.empty((B, 5), np.int64)
    held = []
    for b, g in enumerate(graphs):
        idx, cost, isrep, units = g.padded()
        arrs = (_c(idx, np.int32), _c(cost, np.float32), _c(isrep, np.bool_),
                _c(units, np.int32), _c(g.sites, np.float64))
        held.append(arrs)
        dims[b] = (idx.shape[0], idx.shape[1], arrs[4].shape[1])
        ptrs[b] = [_d(a) for a in arrs]
    sizes = np.empty((B, 3), np.int32)
    h = _staged(L.gc_clean_batch_begin(B, _d(dims), _d(ptrs),
                                       np.float32(repeat_ext), _d(sizes),
                                       n_threads()), "gc_clean_batch_begin")
    try:
        if (sizes[:, 0] < 0).any():
            raise AssertionError("clean_graph reachability invariant")
        out = np.zeros((B, 6), np.int64)
        res = [None] * B
        for b, (st, m, E) in enumerate(sizes.tolist()):
            if st == 1:
                continue
            if m < 2 or E < 1:
                raise RuntimeError("gc_clean_batch_begin: graph %d cleans to "
                                   "%d nodes of width %d" % (b, m, E))
            arrs = (np.empty((m, dims[b, 2]), np.float64),
                    np.empty(m, np.int64), np.empty((m, E), np.int32),
                    np.empty((m, E), np.float32), np.empty((m, E), np.bool_),
                    np.empty((m, E), np.int32))
            out[b] = [_d(a) for a in arrs]
            res[b] = arrs
        if L.gc_clean_batch_finish(h, _d(sizes), _d(out), n_threads()) < 0:
            raise MemoryError("gc_clean_batch_finish: an item could not "
                              "allocate")
    finally:
        L.gc_batch_free(h)
    return res


def align_batch(items):
    """gc_align_batch_begin/finish over (g1, g2, model, scores) items: per
    item an AlignmentResult (mappings as int32 arrays), or None where
    align_node_native declines the pair (a repeat edge, or the backtrack
    failed; the caller aligns those its staged way)."""
    from ..align.backtrack import AlignmentResult

    L = lib()
    B = len(items)
    dims = np.empty((B, 5), np.int32)
    ptrs = np.empty((B, 10), np.int64)
    scal = np.empty((B, 8), np.float32)
    held = []
    for b, (g1, g2, model, sc) in enumerate(items):
        idx1, cost1, isrep1, _ = g1.padded()
        idx2, cost2, isrep2, _ = g2.padded()
        arrs = (_c(idx1, np.int32), _c(cost1, np.float32),
                _c(isrep1, np.bool_), _c(idx2, np.int32),
                _c(cost2, np.float32), _c(isrep2, np.bool_),
                _c(g1.sites, np.float64), _c(g2.sites, np.float64),
                _c(model.M, np.float64), _c(model.pi, np.float64))
        held.append(arrs)
        dims[b] = (idx1.shape[0], idx2.shape[0], idx1.shape[1],
                   idx2.shape[1], arrs[8].shape[0])
        ptrs[b] = [_d(a) for a in arrs]
        scal[b] = (sc.match_init, sc.gap_extend, sc.gap_init, sc.start_gap,
                   sc.start_init, sc.end_match, sc.end_gap, sc.end_skip)
    n = np.empty(B, np.int32)
    score = np.empty(B, np.float32)
    h = _staged(L.gc_align_batch_begin(B, _d(dims), _d(ptrs), _d(scal),
                                       _d(n), _d(score), n_threads()),
                "gc_align_batch_begin")
    try:
        total = int(n[n > 0].sum())
        maps = np.empty((2, total), np.int32)
        L.gc_align_batch_finish(h, _d(n), _d(maps[0]), _d(maps[1]))
    finally:
        L.gc_batch_free(h)
    out, o = [None] * B, 0
    for b, k in enumerate(n.tolist()):
        if k < 0:
            continue
        out[b] = AlignmentResult(score=score[b], n_tr_indels=0,
                                 mapping1=maps[0, o:o + k],
                                 mapping2=maps[1, o:o + k])
        o += k
    return out


def merge_batch(nodes):
    """gc_merge_batch_begin/finish over nodes (mapping1, mapping2 of the
    cleaned graphs, outmapping1, outmapping2, g1, g2, P1, P2, up1, up2):
    per node (sites [n, dim] float64, m1 [n] int32, m2,
    matched [n] bool, idx, cost, isrep, units [n, E]), identical to
    merge_graphs' native branch on the uncleaned mappings.  Raises
    AssertionError("error in mapping") as unify_native does, also for a
    mapping index outside its graph."""
    L = lib()
    gemv, ddot, blas64, _ = _blas_ptrs()
    B = len(nodes)
    dims = np.empty((B, 8), np.int32)
    ptrs = np.empty((B, 16), np.int64)
    ups = np.empty((B, 2), np.float32)
    held = []
    for b, (map1, map2, om1, om2, g1, g2, P1, P2, up1,
            up2) in enumerate(nodes):
        a1, a2 = _c(np.asarray(map1), np.int32), _c(np.asarray(map2),
                                                     np.int32)
        if a1.shape != a2.shape or a1.ndim != 1:
            raise ValueError("merge_batch: node %d's mappings have shapes "
                             "%s and %s" % (b, a1.shape, a2.shape))
        p1, p2 = g1.padded(), g2.padded()
        arrs = (a1, a2, _c(om1, np.int64), _c(om2, np.int64),
                _c(g1.sites, np.float64), _c(p1[0], np.int32),
                _c(p1[1], np.float32), _c(p1[2], np.bool_),
                _c(p1[3], np.int32), _c(g2.sites, np.float64),
                _c(p2[0], np.int32), _c(p2[1], np.float32),
                _c(p2[2], np.bool_), _c(p2[3], np.int32),
                _c(P1, np.float64), _c(P2, np.float64))
        held.append(arrs)
        dims[b] = (len(a1), p1[0].shape[0], p1[0].shape[1], p2[0].shape[0],
                   p2[0].shape[1], arrs[4].shape[1], len(arrs[2]),
                   len(arrs[3]))
        ptrs[b] = [_d(a) for a in arrs]
        ups[b] = (up1, up2)
    sizes = np.empty((B, 3), np.int32)
    h = _staged(L.gc_merge_batch_begin(B, _d(dims), _d(ptrs), _d(ups), gemv,
                                       ddot, blas64, _d(sizes), n_threads()),
                "gc_merge_batch_begin")
    try:
        if (sizes[:, 0] < 0).any():
            raise AssertionError("error in mapping")
        out = np.empty((B, 8), np.int64)
        res = []
        for b, (_st, n, E) in enumerate(sizes.tolist()):
            if n < 2 or E < 1:
                raise RuntimeError("gc_merge_batch_begin: node %d merges to "
                                   "%d nodes of width %d" % (b, n, E))
            arrs = (np.empty((n, dims[b, 5]), np.float64),
                    np.empty(n, np.int32), np.empty(n, np.int32),
                    np.empty(n, np.bool_), np.empty((n, E), np.int32),
                    np.empty((n, E), np.float32), np.empty((n, E), np.bool_),
                    np.empty((n, E), np.int32))
            out[b] = [_d(a) for a in arrs]
            res.append(arrs)
        if L.gc_merge_batch_finish(h, _d(sizes), _d(out), n_threads()) < 0:
            raise MemoryError("gc_merge_batch_finish: an item could not "
                              "allocate")
    finally:
        L.gc_batch_free(h)
    return res


def extend_batch(nodes, gap_code):
    """gc_extend_batch: per node (dest [C, R] int16, [(mapping [C + 2]
    int32, src, rows), ...] one entry a child in turn), where src is the
    child's rows as a RowBlock lays them out ([k, rows] int16): each
    child's mapped columns take its source columns in order, the others
    the gap code; the children's rows sit side by side in dest.  Raises
    ValueError where a child maps more columns than its source holds
    (numpy's shape error)."""
    L = lib()
    B = len(nodes)
    dims = np.empty((B, 2), np.int32)
    ptrs = np.empty(B, np.int64)
    coff = np.empty(B, np.int32)
    K = sum(len(ch) for _dest, ch in nodes)
    cdims = np.empty((max(K, 1), 2), np.int32)
    cptrs = np.empty((max(K, 1), 2), np.int64)
    held = []
    c = 0
    for b, (dest, children) in enumerate(nodes):
        if dest.dtype != np.int16 or not dest.flags.c_contiguous:
            raise ValueError("extend_batch: node %d's block is not a "
                             "C-contiguous int16 array" % b)
        C, R = dest.shape
        dims[b] = (C, len(children))
        ptrs[b] = _d(dest)
        coff[b] = c
        rows_sum = 0
        for mapping, src, rows in children:
            m = _c(np.asarray(mapping), np.int32)
            s = _c(np.asarray(src), np.int16)
            if m.shape != (C + 2,) or s.ndim != 2 or s.shape[1] != rows:
                raise ValueError("extend_batch: node %d's child has mapping "
                                 "%s and source %s for %d rows"
                                 % (b, m.shape, s.shape, rows))
            held.append((m, s))
            cdims[c] = (rows, s.shape[0])
            cptrs[c] = (_d(m), _d(s))
            rows_sum += rows
            c += 1
        if rows_sum != R:
            raise ValueError("extend_batch: node %d's block holds %d rows, "
                             "its children %d" % (b, R, rows_sum))
    bad = np.empty(B, np.int32)
    L.gc_extend_batch(B, _d(dims), _d(ptrs), _d(coff), _d(cdims), _d(cptrs),
                      int(gap_code), _d(bad), n_threads())
    if bad.any():
        raise ValueError("extend_batch: node %d's child maps more columns "
                         "than its rows hold" % int(np.flatnonzero(bad)[0]))
