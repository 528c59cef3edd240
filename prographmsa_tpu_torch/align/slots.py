"""Sentinels, limits and slot tables of the device graph-pair DP.

The port's copy of what it needs from prographmsa_tpu/align/
graph_dp_pallas.py: the finite float32 sentinels (decision codes and
unreachable-cell values depend on their exact values; csrc/common.cuh holds
the same bit patterns), the per-pair limits behind the ``fb_*`` fallback
rules, the decision-code field width, and the offset-slot cost tables in
host PredIterator order.
"""

from __future__ import annotations

import numpy as np

from .backtrack import STATE_M, STATE_X, STATE_Y  # noqa: F401  (re-export)

NEG = np.float32(-1e37)          # finite "-inf"
COST_INF = np.float32(1e37)      # finite "+inf" edge cost
FLOOR = np.float32(-3e38)        # max-accumulator init (< any candidate)
BIG = np.float32(3e38)           # min-accumulator init (> any |diff|)

MAX_N = 4096                     # per-side node cap
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
    """Offset-slot costs with repeat flags, in PredIterator candidate order.

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
    n = graph.size
    off_n, off_r = set(), set()
    for i in range(n):
        for p, _ in graph.preds[i]:
            off_n.add(i - p)
        for p, _ in graph.reps[i]:
            off_r.add(i - p)
    off_n = sorted(off_n)
    off_r = sorted(off_r)
    slots = off_r + off_n
    if len(slots) > max_offsets:
        return None
    m = max(1, len(slots))
    C = np.full((n, m), np.inf, dtype=np.float32)
    rep = np.zeros((n, m), dtype=bool)
    nmap = {o: len(off_r) + k for k, o in enumerate(off_n)}
    rmap = {o: k for k, o in enumerate(off_r)}
    ri = np.float32(scores.repeat_init)
    re = np.float32(scores.repeat_ext)
    for i in range(n):
        for p, c in graph.preds[i]:
            k = nmap[i - p]
            c32 = np.float32(c)
            if c32 < C[i, k]:
                C[i, k] = c32
        for p, u in graph.reps[i]:
            k = rmap[i - p]
            with np.errstate(invalid="ignore"):
                rc = np.float32(ri + re * np.float32(u - 1))
            if np.isnan(rc):
                continue                     # NaN cost: never chosen
            if rc < C[i, k]:
                C[i, k] = rc
            rep[i, k] = True
    return (np.array(slots, dtype=np.int32) if slots
            else np.array([1], dtype=np.int32)), C, rep
