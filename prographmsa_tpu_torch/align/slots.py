"""Sentinels, limits and slot tables of the device graph-pair DP.

The port's copy of what it needs from prographmsa_tpu/align/
graph_dp_pallas.py: the finite float32 sentinels (decision codes and
unreachable-cell values depend on their exact values; csrc/common.cuh holds
the same bit patterns), the per-pair limits behind the ``fb_offsets`` and
``fb_reach`` fallback rules (the code format K3 and X1 share with the JAX
package), the decision-code field width, and the offset-slot cost tables
in host PredIterator order.  A pair's size is bounded by the card's
kernels and launches instead (graph_dp_cuda.launch_fits), not by a
per-side node cap.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .backtrack import STATE_M, STATE_X, STATE_Y  # noqa: F401  (re-export)

NEG = np.float32(-1e37)          # finite "-inf"
COST_INF = np.float32(1e37)      # finite "+inf" edge cost
FLOOR = np.float32(-3e38)        # max-accumulator init (< any candidate)
BIG = np.float32(3e38)           # min-accumulator init (> any |diff|)

MAX_OFF = 64                     # offset-slot cap (largest tier's op)

# tiers: (op = offset slots per side, R = ring diagonals); a pair needs the
# smallest tier with op >= max(nlen1, nlen2); the largest R bounds the reach
# (fb_reach), and op > 16 widens the decision-code fields to 6 bits
TIERS = ((2, 8), (4, 16), (8, 64), (16, 128), (32, 256), (64, 256))

EV_CAP = 8                       # repeat events per pair before host bail


def shb(op: int) -> int:
    """Decision-code slot-field width: 4-bit i/j fields for op <= 16, 6-bit
    for the larger tiers."""
    return 4 if op <= 16 else 6


def offset_costs_rep(graph, scores, max_offsets: int):
    """Offset-slot costs with repeat flags, in PredIterator candidate order:
    the native library's tables where it loads, else the numpy body below,
    bit for bit the same.

    Returns (offsets [m] i32, C [n, m] f32, rep [n, m] bool) or None if
    the graph needs more than ``max_offsets`` slots.  Slots are SPLIT BY
    KIND: repeat-edge offsets (ascending) occupy the front of the array,
    normal-edge offsets (ascending) the back.  The fill and the chase both
    walk slots from the BACK of the array forward, so candidates are
    visited normal-desc-offset (= ascending predecessor index) THEN
    repeat-desc-offset — exactly the host PredIterator's
    normals-before-repeats order (Graph.h:180-248).  This makes
    cross-kind cost TIES resolve to the normal edge like the host (a
    same-offset min over both kinds would mis-order repeat-slot candidates
    against lower-offset normal slots on ties; the rep8 fixtures show it).

    C[i, k] = min cost over same-kind edges i -> i-offsets[k]
    (normal edges as stored; repeat edges repeat_init +
    repeat_ext*(units-1), NaN (inf*0) => unreachable); rep[i, k] is True
    iff slot k is a repeat slot with a real edge into node i (the chase
    records a markAlternativePath event when it steps through one)."""
    return _slot_tables(graph, scores, max_offsets, None)


def capped_offset_costs(graph, scores, max_offsets: int):
    """``offset_costs_rep`` with every non-finite cost replaced by COST_INF
    (``inf_to_cap``): the tables a pair of the device batch carries."""
    return _slot_tables(graph, scores, max_offsets, COST_INF)


def inf_to_cap(C):
    """C with every non-finite entry (+inf, -inf, NaN) set to COST_INF, the
    finite "no edge" of the device batch."""
    return np.where(np.isfinite(C), C, COST_INF).astype(np.float32)


def _slot_tables(graph, scores, max_offsets, cap_value):
    ri = np.float32(scores.repeat_init)
    re = np.float32(scores.repeat_ext)
    if native.lib() is not None:
        return native.offset_costs_native(graph.padded(), ri, re,
                                          max_offsets, cap_value)
    out = _offset_costs_rep_numpy(graph, scores, max_offsets)
    if out is None or cap_value is None:
        return out
    return out[0], inf_to_cap(out[1]), out[2]


def _offset_costs_rep_numpy(graph, scores, max_offsets: int):
    """``offset_costs_rep`` in numpy, the path without the native
    library."""
    n = graph.size
    idx, cost, isrep, units = graph.padded()
    to, col = np.nonzero(idx >= 0)           # row-major: PredIterator order
    off = to - idx[to, col]
    is_rep = isrep[to, col]
    off_n = np.unique(off[~is_rep])
    off_r = np.unique(off[is_rep])
    if len(off_r) + len(off_n) > max_offsets:
        return None
    m = max(1, len(off_r) + len(off_n))
    C = np.full((n, m), np.inf, dtype=np.float32)
    rep = np.zeros((n, m), dtype=bool)
    nrm = ~is_rep
    _first_min(C, to[nrm], len(off_r) + np.searchsorted(off_n, off[nrm]),
               cost[to[nrm], col[nrm]])
    ri = np.float32(scores.repeat_init)
    re = np.float32(scores.repeat_ext)
    with np.errstate(invalid="ignore"):
        rc = ri + re * (units[to[is_rep], col[is_rep]] - 1).astype(np.float32)
    real = ~np.isnan(rc)                     # NaN cost: never chosen
    rto = to[is_rep][real]
    rk = np.searchsorted(off_r, off[is_rep][real])
    _first_min(C, rto, rk, rc[real])
    rep[rto, rk] = True
    slots = np.concatenate([off_r, off_n]).astype(np.int32)
    return (slots if len(slots) else np.array([1], dtype=np.int32)), C, rep


def _first_min(C, rows, cols, vals):
    """C[r, c] = min(C[r, c], vals) per cell as a loop of strict ``<``
    updates in the given order would leave it: the first of equal values
    (0.0 and -0.0) is kept and NaN never wins."""
    keep = ~np.isnan(vals)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if not len(vals):
        return
    cell = rows * C.shape[1] + cols
    order = np.lexsort((np.arange(len(vals)), vals, cell))
    first = np.ones(len(order), dtype=bool)
    first[1:] = cell[order][1:] != cell[order][:-1]
    pick = order[first]
    better = vals[pick] < C[rows[pick], cols[pick]]
    C[rows[pick][better], cols[pick][better]] = vals[pick][better]
