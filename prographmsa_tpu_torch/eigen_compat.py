"""Floating-point-compatible reductions matching Eigen's SSE2 redux.

BioNJ tie-breaking (tree/nj.py) depends on the exact rounding of the
distance-matrix column sums: at dim=4 the Q-matrix minimum is an exact
mathematical tie between complementary pairs, and the winner is decided by
accumulated rounding noise.  The reference binary (Eigen ~3.1, SSE2) sums a
contiguous aligned column of doubles with two 2-wide packet accumulators:

    acc0 = v[0:2] + v[4:6] + v[8:10] + ...
    acc1 = v[2:4] + v[6:8] + ...
    acc0 += acc1; (+ trailing packet if n%4>=2); res = acc0[0]+acc0[1]
    then scalar remainder elements appended left-to-right
    (Eigen/src/Core/Redux.h, LinearVectorizedTraversal)

Columns of a heap-allocated col-major matrix start 16-byte aligned iff
(col * rows) is even; unaligned columns peel the first element into the
scalar epilogue.  ``eigen_colwise_sum`` reproduces all of this, making our
double-precision NJ bit-identical to the reference where the inputs are
(which holds for the prealigned-distance iterations).
"""

from __future__ import annotations

import numpy as np


def _redux_contiguous(v: np.ndarray, aligned_start: int) -> float:
    """Eigen vectorized sum of one contiguous double column."""
    n = v.size
    body = n - aligned_start
    packet = 2
    aligned_size = (body // packet) * packet
    aligned_size2 = (body // (2 * packet)) * (2 * packet)
    aligned_end = aligned_start + aligned_size
    aligned_end2 = aligned_start + aligned_size2

    if aligned_size > packet:
        acc0 = v[aligned_start:aligned_start + 2].copy()
        acc1 = v[aligned_start + 2:aligned_start + 4].copy()
        i = aligned_start + 4
        while i < aligned_end2:
            acc0 += v[i:i + 2]
            acc1 += v[i + 2:i + 4]
            i += 4
        acc0 += acc1
        if aligned_end > aligned_end2:
            acc0 += v[aligned_end2:aligned_end2 + 2]
        res = acc0[0] + acc0[1]
        for i in range(aligned_start):
            res = res + v[i]
        for i in range(aligned_end, n):
            res = res + v[i]
        return res
    res = v[0]
    for i in range(1, n):
        res = res + v[i]
    return res


def _redux_columns(V: np.ndarray, a: int) -> np.ndarray:
    """_redux_contiguous for every column of V [rows, k] at once, same
    aligned_start ``a`` for all.  Per-column floating-point operation order
    is identical to the scalar routine (vectorizing across columns never
    reorders the adds within a column), so results are bit-identical."""
    n, k = V.shape
    body = n - a
    packet = 2
    aligned_size = (body // packet) * packet
    aligned_size2 = (body // (2 * packet)) * (2 * packet)
    aligned_end = a + aligned_size
    aligned_end2 = a + aligned_size2

    if aligned_size > packet:
        blocks = V[a:aligned_end2].reshape(-1, 2, 2, k)     # [nb, 2, 2, k]
        acc0 = blocks[0, 0].copy()
        acc1 = blocks[0, 1].copy()
        for b in range(1, blocks.shape[0]):
            acc0 += blocks[b, 0]
            acc1 += blocks[b, 1]
        acc0 += acc1
        if aligned_end > aligned_end2:
            acc0 += V[aligned_end2:aligned_end2 + 2]
        res = acc0[0] + acc0[1]
        for i in range(a):
            res = res + V[i]
        for i in range(aligned_end, n):
            res = res + V[i]
        return res
    res = V[0].copy()
    for i in range(1, n):
        res = res + V[i]
    return res


def eigen_colwise_sum(M: np.ndarray) -> np.ndarray:
    """colwise().sum() of a col-major heap matrix, Eigen/SSE2 rounding.
    Columns share the packet schedule, differing only in aligned_start
    parity — so the whole matrix reduces in two vectorized groups."""
    rows, cols = M.shape
    out = np.empty(cols, dtype=np.float64)
    if cols == 0 or rows == 0:
        return out
    Mc = np.asfortranarray(M, dtype=np.float64)
    if rows % 2 == 0:
        out[:] = _redux_columns(Mc, 0)
        return out
    even = np.arange(0, cols, 2)
    odd = np.arange(1, cols, 2)
    out[even] = _redux_columns(Mc[:, even], 0)
    if odd.size:
        out[odd] = _redux_columns(Mc[:, odd], 1)
    return out


def eigen_seq_sum(v: np.ndarray) -> float:
    """Scalar left-to-right sum (Eigen DefaultTraversal, used for strided
    row expressions like ``(V.row(i2)-V.row(i1)).sum()``)."""
    res = v[0]
    for x in v[1:]:
        res = res + x
    return float(res)
