"""DP backtracking and repeat alternative-path marking.

Direct behavioral port of GraphAlign.h:283-534 (host-side
— the traceback is O(path length) with small per-step pred scans, while the
O(n1·n2) fill runs on device).  The reference re-derives each traceback step
by finding the candidate transition whose score matches the stored DP value
most closely (min |difference|, strict improvement, pred-scan order); we
reproduce that exactly, in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

f32 = np.float32
INF = np.float32(np.inf)

STATE_M, STATE_X, STATE_Y = 0, 1, 2


@dataclass
class AlignmentResult:
    score: np.float32
    n_tr_indels: int
    mapping1: List[int]
    mapping2: List[int]


def mark_alternative_path(start: int, end: int, graph, mapping: List[int],
                          other_mapping: List[int]) -> None:
    """Longest-(min-cost)-path sub-DP emitting skipped repeat-unit nodes as
    unmatched columns (GraphAlign.h:166-198)."""
    length = end - start + 1
    score = np.full(length, -np.inf, dtype=f32)
    prev = np.full(length, -1, dtype=np.int64)
    score[0] = 0.0
    for i in range(1, length):
        real_ix = i + start
        for p, c, _, _ in graph.pred_items(real_ix, INF, INF):
            if start <= p <= end:
                i2 = p - start
                if score[i] <= f32(score[i2] - c):
                    score[i] = f32(score[i2] - c)
                    prev[i] = i2
    if score[length - 1] > -np.inf:
        i = prev[length - 1]
        while i != 0:
            mapping.append(i + start)
            other_mapping.append(-1)
            i = prev[i]


def backtrack(g1, g2, dp, scores) -> AlignmentResult:
    n1, n2 = g1.size, g2.size
    M, X, Y, W, S = dp.M, dp.X, dp.Y, dp.W, dp.S
    Wend = dp.Wend
    ri, re = scores.repeat_init, scores.repeat_ext

    mapping1: List[int] = []
    mapping2: List[int] = []

    def push(y, x):
        mapping1.append(y)
        mapping2.append(x)

    n_tr_indels = 0
    current_state = STATE_M
    current_score = f32(-np.inf)
    y, x = n1 - 1, n2 - 1
    push(y, x)

    # --- transitions to the end state (GraphAlign.h:304-353) ---
    tr_indel_x = False
    tr_indel_y = False
    best_match = INF
    for yp, cy, yrep, _ in g1.pred_items(n1 - 1, ri, re):
        for xp, cx, xrep, _ in g2.pred_items(n2 - 1, ri, re):
            d = abs(f32(Wend - f32(M[yp, xp] + scores.end_match - cy - cx)))
            if best_match > d:
                best_match = d
                tr_indel_x, tr_indel_y = xrep, yrep
                current_score = M[yp, xp]
                current_state = STATE_M
                y, x = yp, xp
            d = abs(f32(Wend - f32(Y[yp, xp] + scores.end_gap - cy - cx)))
            if best_match > d:
                best_match = d
                tr_indel_x, tr_indel_y = xrep, yrep
                current_score = Y[yp, xp]
                current_state = STATE_Y
                y, x = yp, xp
            d = abs(f32(Wend - f32(X[yp, xp] + scores.end_gap - cy - cx)))
            if best_match > d:
                best_match = d
                tr_indel_x, tr_indel_y = xrep, yrep
                current_score = X[yp, xp]
                current_state = STATE_X
                y, x = yp, xp
            if xp == 0 and yp == 0:
                d = abs(f32(Wend - f32(scores.end_skip - cy - cx)))
                if best_match > d:
                    best_match = d
                    tr_indel_x, tr_indel_y = xrep, yrep
                    y, x = yp, xp
    n_tr_indels += int(tr_indel_x) + int(tr_indel_y)

    if tr_indel_y:
        mark_alternative_path(y, n1 - 1, g1, mapping1, mapping2)
    if tr_indel_x:
        mark_alternative_path(x, n2 - 1, g2, mapping2, mapping1)

    if x != 0 or y != 0:
        if current_state == STATE_M:
            push(y, x)
        elif current_state == STATE_X:
            push(-1, x)
        elif current_state == STATE_Y:
            push(y, -1)

    # --- non-end transitions (GraphAlign.h:370-517) ---
    next_score = INF
    next_state = STATE_M
    next_x = next_y = -1
    while x != 0 or y != 0:
        best_match = INF

        def resolve_w_state(ny, nx):
            """W==M / W==Y / W==X resolution order (GraphAlign.h:400-411)."""
            if W[ny, nx] == M[ny, nx]:
                return M[ny, nx], STATE_M
            if W[ny, nx] == Y[ny, nx]:
                return Y[ny, nx], STATE_Y
            if W[ny, nx] == X[ny, nx]:
                return X[ny, nx], STATE_X
            raise RuntimeError("backtracking failed")

        if current_state == STATE_Y:
            for yp, cy, yrep, _ in g1.pred_items(y, ri, re):
                d = abs(f32(current_score - f32(Y[yp, x] + scores.gap_extend - cy)))
                if best_match > d:
                    best_match = d
                    tr_indel_x, tr_indel_y = False, yrep
                    next_x, next_y = x, yp
                    next_score = Y[next_y, next_x]
                    next_state = STATE_Y
                d = abs(f32(current_score - f32(W[yp, x] + scores.gap_init - cy)))
                if best_match > d:
                    best_match = d
                    tr_indel_x, tr_indel_y = False, yrep
                    next_x, next_y = x, yp
                    if next_x != 0 or next_y != 0:
                        next_score, next_state = resolve_w_state(next_y, next_x)

        if current_state == STATE_X:
            for xp, cx, xrep, _ in g2.pred_items(x, ri, re):
                d = abs(f32(current_score - f32(X[y, xp] + scores.gap_extend - cx)))
                if best_match > d:
                    best_match = d
                    tr_indel_x, tr_indel_y = xrep, False
                    next_x, next_y = xp, y
                    next_score = X[next_y, next_x]
                    next_state = STATE_X
                d = abs(f32(current_score - f32(W[y, xp] + scores.gap_init - cx)))
                if best_match > d:
                    best_match = d
                    tr_indel_x, tr_indel_y = xrep, False
                    next_x, next_y = xp, y
                    if next_x != 0 or next_y != 0:
                        next_score, next_state = resolve_w_state(next_y, next_x)

        if current_state == STATE_M:
            for yp, cy, yrep, _ in g1.pred_items(y, ri, re):
                for xp, cx, xrep, _ in g2.pred_items(x, ri, re):
                    d = abs(f32(current_score
                                - f32(W[yp, xp] + S[y, x] - cy - cx)))
                    if best_match > d:
                        best_match = d
                        tr_indel_x, tr_indel_y = xrep, yrep
                        next_y, next_x = yp, xp
                        if next_x != 0 or next_y != 0:
                            next_score, next_state = resolve_w_state(next_y,
                                                                     next_x)
        n_tr_indels += int(tr_indel_x) + int(tr_indel_y)

        if tr_indel_y:
            mark_alternative_path(next_y, y, g1, mapping1, mapping2)
        if tr_indel_x:
            mark_alternative_path(next_x, x, g2, mapping2, mapping1)

        x, y = next_x, next_y
        current_state = next_state
        current_score = next_score

        if x != 0 or y != 0:
            if current_state == STATE_M:
                push(y, x)
            elif current_state == STATE_X:
                push(-1, x)
            elif current_state == STATE_Y:
                push(y, -1)
    push(0, 0)

    mapping1.reverse()
    mapping2.reverse()
    return AlignmentResult(score=Wend, n_tr_indels=n_tr_indels,
                           mapping1=mapping1, mapping2=mapping2)
