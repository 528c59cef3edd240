"""Device graph-pair DP for a batch of pairs: exact S (K1 + K2), the
wavefront fill (K3) and the code chase (X1), then the host harvest.

The port of prographmsa_tpu/align/graph_dp_pallas.py:align_pairs_device,
with the same signature and return value: ``items`` is a list of
(g1, g2, model, scores) and the result per pair is
(mapping1, mapping2, score, n_tr_indels), or None when the pair leaves the
device path; the caller then aligns it on the host.  Every such pair is
counted under its reason in ``fallback_stats()``:
  fb_size     a side has more than MAX_N nodes;
  fb_offsets  more than MAX_OFF distinct predecessor offsets on a side;
  fb_reach    largest offset sum above 254 (ring of more than 256 diagonals);
  fb_rep      more than EV_CAP repeat events on the walk;
  fb_chase    the walk did not reach the origin (never seen: a guard).
The reference counts chase failures as fb_rep; here they are apart.  Its
TPU-only rules (the VMEM fb_size rule for large rings, fb_spread of its
8-pair groups) have no counterpart here.

Pair preparation builds the slot tables with ``slots.offset_costs_rep``, so
the slot order is the host PredIterator order.  ``pack_pairs`` turns the
port's host objects (graph sites and edges, model M/pi, DynProgScores) into
the batch tensors.  A pair's S plane and code plane are padded to the
launch's largest pair, so pairs are sorted by size and cut into launches of
bounded memory; each launch carries the fill's layout on the card
(``fill_cuda.plan_fill``: blocks per pair from the launch's pair count and
sizes, lanes per cell from the graphs' in-degrees).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import timings
from .backtrack import mark_alternative_path
from .chase_cuda import (META_FAIL_CHASE, META_FAIL_REP, META_LEN,
                         META_SCORE, N_META, chase)
from .fill_cuda import FillPlan, card_limits, fill, plan_fill
from .scores_cuda import exact_s
from .slots import (COST_INF, EV_CAP, MAX_N, MAX_OFF, TIERS,
                    offset_costs_rep, shb)

MAX_R = max(r for _, r in TIERS)          # ring diagonals per pair
LAUNCH_BYTES = 1 << 30                    # S + code planes of one launch

FALLBACK_KEYS = ("pairs_total", "pairs_device", "fb_offsets", "fb_size",
                 "fb_reach", "fb_rep", "fb_chase")
_fallback_stats = {k: 0 for k in FALLBACK_KEYS}


def fallback_stats():
    return dict(_fallback_stats)


class PairPrep(NamedTuple):
    idx: int
    g1: object
    g2: object
    model: object
    scores: object
    o1: np.ndarray        # [nl1] offsets per slot (repeat slots first)
    C1: np.ndarray        # [n1, nl1] slot edge costs into each node
    rep1: np.ndarray      # [n1, nl1] repeat-slot flags
    o2: np.ndarray
    C2: np.ndarray
    rep2: np.ndarray
    R: int                # ring diagonals: reach + 2
    shb: int              # decision-code slot-field width


def prep_pair(idx, g1, g2, model, scores):
    """Slot tables for one pair, or the name of its fallback counter."""
    if g1.size > MAX_N or g2.size > MAX_N:
        return "fb_size"
    oc1 = offset_costs_rep(g1, scores, MAX_OFF)
    oc2 = offset_costs_rep(g2, scores, MAX_OFF)
    if oc1 is None or oc2 is None:
        return "fb_offsets"
    (o1, C1, rep1), (o2, C2, rep2) = oc1, oc2
    R = int(o1.max()) + int(o2.max()) + 2
    if R > MAX_R:
        return "fb_reach"
    need = max(len(o1), len(o2))
    width = shb(min(op for op, _ in TIERS if op >= need))
    inf_to_cap = lambda C: np.where(np.isfinite(C), C,
                                    COST_INF).astype(np.float32)
    return PairPrep(idx, g1, g2, model, scores, o1, inf_to_cap(C1), rep1,
                    o2, inf_to_cap(C2), rep2, R, width)


class Batch(NamedTuple):
    g1T: torch.Tensor     # [B, dim, n1max] f32
    g2T: torch.Tensor     # [B, dim, n2max] f32
    M: torch.Tensor       # [B, dim, dim] f32
    pi: torch.Tensor      # [B, dim] f32
    mi: torch.Tensor      # [B] f32 match_init
    n1: torch.Tensor      # [B] int32
    n2: torch.Tensor
    O1: torch.Tensor      # [B, opmax] int32
    O2: torch.Tensor
    C1T: torch.Tensor     # [B, opmax, n1max] f32
    C2T: torch.Tensor     # [B, opmax, n2max] f32
    R1T: torch.Tensor     # [B, opmax, n1max] uint8
    R2T: torch.Tensor
    iv: torch.Tensor      # [B, 8] int32: n1, n2, nl1, nl2, R, shb
    par: torch.Tensor     # [B, 8] f32: ge, gi, sg, si, em, eg, es
    Rmax: int
    Lm: int               # mapping capacity per pair
    plan: FillPlan        # the fill's layout on the card for this launch


def _cands_per_cell(p) -> float:
    """Mean match candidates per cell of a pair: the product of the two
    graphs' mean in-degrees over their slots."""
    return (np.count_nonzero(p.C1 < COST_INF) / p.g1.size
            * np.count_nonzero(p.C2 < COST_INF) / p.g2.size)


def pack_pairs(preps, device) -> Batch:
    """The batch tensors of ``preps`` (built on the host, one copy each to
    ``device``) and the fill's plan for that device."""
    B = len(preps)
    dim = preps[0].g1.dim
    n1max = max(p.g1.size for p in preps)
    n2max = max(p.g2.size for p in preps)
    opmax = max(max(len(p.o1), len(p.o2)) for p in preps)
    f32 = np.float32
    g1T = np.zeros((B, dim, n1max), f32)
    g2T = np.zeros((B, dim, n2max), f32)
    M = np.zeros((B, dim, dim), f32)
    pi = np.zeros((B, dim), f32)
    mi = np.zeros(B, f32)
    n1 = np.zeros(B, np.int32)
    n2 = np.zeros(B, np.int32)
    O1 = np.ones((B, opmax), np.int32)
    O2 = np.ones((B, opmax), np.int32)
    C1T = np.full((B, opmax, n1max), COST_INF, f32)
    C2T = np.full((B, opmax, n2max), COST_INF, f32)
    R1T = np.zeros((B, opmax, n1max), np.uint8)
    R2T = np.zeros((B, opmax, n2max), np.uint8)
    iv = np.zeros((B, 8), np.int32)
    par = np.zeros((B, 8), f32)
    for b, p in enumerate(preps):
        a1, a2 = p.g1.size, p.g2.size
        k1, k2 = len(p.o1), len(p.o2)
        g1T[b, :, :a1] = p.g1.sites.T
        g2T[b, :, :a2] = p.g2.sites.T
        M[b] = p.model.M
        pi[b] = p.model.pi
        sc = p.scores
        mi[b] = f32(sc.match_init)
        n1[b], n2[b] = a1, a2
        O1[b, :k1] = p.o1
        O2[b, :k2] = p.o2
        C1T[b, :k1, :a1] = p.C1.T
        C2T[b, :k2, :a2] = p.C2.T
        R1T[b, :k1, :a1] = p.rep1.T
        R2T[b, :k2, :a2] = p.rep2.T
        iv[b, :6] = (a1, a2, k1, k2, p.R, p.shb)
        par[b, :7] = (sc.gap_extend, sc.gap_init, sc.start_gap,
                      sc.start_init, sc.end_match, sc.end_gap, sc.end_skip)
    t = lambda a: torch.from_numpy(a).to(device)
    Rmax = max(p.R for p in preps)
    sms, max_blocks = card_limits(device)
    return Batch(t(g1T), t(g2T), t(M), t(pi), t(mi), t(n1), t(n2), t(O1),
                 t(O2), t(C1T), t(C2T), t(R1T), t(R2T), t(iv), t(par),
                 Rmax, n1max + n2max + 8,
                 plan_fill(B, n1max, Rmax,
                           max(_cands_per_cell(p) for p in preps), sms=sms,
                           max_blocks=max_blocks))


def run_batch(bt: Batch):
    """S, fill and chase of one launch; the packed [B, W] int32 result
    (still on the batch's device)."""
    Sdiag = exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    fo = fill(Sdiag, bt.O1, bt.O2, bt.C1T, bt.C2T, bt.iv, bt.par, bt.Rmax,
              bt.plan)
    return chase(fo, bt.O1, bt.O2, bt.C1T, bt.C2T, bt.R1T, bt.R2T, bt.iv,
                 bt.par, bt.Lm)


def _launches(preps):
    """Cut the size-sorted pairs into launches whose padded S and code
    planes (8 bytes per diagonal-major position) stay under LAUNCH_BYTES."""
    preps = sorted(preps, key=lambda p: -(p.g1.size + p.g2.size))
    out, cur, n1max, n2max = [], [], 0, 0
    for p in preps:
        a, b = max(n1max, p.g1.size), max(n2max, p.g2.size)
        if cur and (len(cur) + 1) * (a + b) * a * 8 > LAUNCH_BYTES:
            out.append(cur)
            cur, a, b = [], p.g1.size, p.g2.size
        cur.append(p)
        n1max, n2max = a, b
    if cur:
        out.append(cur)
    return out


def align_pairs_device(items, device):
    """Align a batch of (g1, g2, model, scores) on ``device`` (kernels on
    CUDA, their plain versions on the CPU).  Returns, per pair,
    (mapping1, mapping2, score, n_tr_indels) or None (host fallback).
    Under --timings: dp_prep (slot tables), dp_device (packing, copies,
    kernels and the one fetch per launch) and dp_harvest."""
    results = [None] * len(items)
    _fallback_stats["pairs_total"] += len(items)
    preps = []
    with timings.phase("dp_prep"):
        for idx, (g1, g2, model, scores) in enumerate(items):
            p = prep_pair(idx, g1, g2, model, scores)
            if isinstance(p, str):
                _fallback_stats[p] += 1
            else:
                preps.append(p)
    with timings.phase("dp_device"):
        launched = []
        for chunk in _launches(preps):
            bt = pack_pairs(chunk, device)
            launched.append((chunk, run_batch(bt), bt.Lm))
        fetched = [(chunk, packed.cpu().numpy(), Lm)
                   for chunk, packed, Lm in launched]
    with timings.phase("dp_harvest"):
        for chunk, packed, Lm in fetched:
            _harvest(chunk, packed, Lm, results)
    return results


def _harvest(chunk, packed, Lm, results):
    """Mappings out of the packed rows, with the host markAlternativePath
    columns spliced in at the recorded repeat events."""
    meta = packed[:, 2 * Lm:2 * Lm + N_META]
    ev_lo = 2 * Lm + N_META
    for k, p in enumerate(chunk):
        if meta[k, META_FAIL_REP]:
            _fallback_stats["fb_rep"] += 1
            continue
        if meta[k, META_FAIL_CHASE]:
            _fallback_stats["fb_chase"] += 1
            continue
        ln = int(meta[k, META_LEN])
        score = packed[k, 2 * Lm + META_SCORE:][:1].view(np.float32)[0]
        walk1 = packed[k, :Lm][:ln].tolist()
        walk2 = packed[k, Lm:2 * Lm][:ln].tolist()
        ntr = int(packed[k, ev_lo])
        evb = packed[k, ev_lo + 1:ev_lo + 1 + 4 * EV_CAP].reshape(4, EV_CAP)
        shift = 0
        for side, nxt, cur, at in evb[:, :ntr].T.tolist():
            tmp_m, tmp_o = [], []
            if side == 1:
                mark_alternative_path(nxt, cur, p.g1, tmp_m, tmp_o)
                walk1[at + shift:at + shift] = tmp_m
                walk2[at + shift:at + shift] = tmp_o
            else:
                mark_alternative_path(nxt, cur, p.g2, tmp_m, tmp_o)
                walk2[at + shift:at + shift] = tmp_m
                walk1[at + shift:at + shift] = tmp_o
            shift += len(tmp_m)
        results[p.idx] = (walk1[::-1], walk2[::-1], np.float32(score), ntr)
        _fallback_stats["pairs_device"] += 1
