"""Device graph-pair DP for a batch of pairs: exact S (K1 + K2), the
wavefront fill (K3) and the code chase (X1), then the host harvest.

The port of prographmsa_tpu/align/graph_dp_pallas.py:align_pairs_device,
with the same signature and return value: ``items`` is a list of
(g1, g2, model, scores) and the result per pair is
(mapping1, mapping2, score, n_tr_indels), or None when the pair leaves the
device path; the caller then aligns it on the host.  Every such pair is
counted under its reason in ``fallback_stats()``:
  fb_size     the pair alone does not fit one launch (``launch_fits``:
              its planes exceed LAUNCH_BYTES, or the plan of K1, K2, K3 or
              X1 cannot hold it);
  fb_offsets  more than MAX_OFF distinct predecessor offsets on a side;
  fb_reach    largest offset sum above 254 (ring of more than 256 diagonals);
  fb_rep      more than EV_CAP repeat events on the walk;
  fb_chase    the walk did not reach the origin (never seen: a guard).
The reference counts chase failures as fb_rep; here they are apart.  Its
TPU-only rules (the per-side cap of 4,096 nodes, its HBM plane budget; the
VMEM fb_size rule for large rings; fb_spread of its 8-pair groups) have no
counterpart here: the port's fb_size rule is its own kernels' limits.

Pair preparation builds the slot tables with ``slots.capped_offset_costs``,
so the slot order is the host PredIterator order.  ``pack_pairs`` turns the
port's host objects (graph sites and edges, model M/pi, DynProgScores) into
the batch tensors.  Both build the large arrays in the native library
(native/graphcore.cpp) where it loads, else in numpy, bit for bit the
same.  A pair's S plane and code plane are padded to the launch's largest
pair, so pairs are sorted by size and cut into launches of bounded memory; each launch carries the fill's layout on the card
(``fill_cuda.plan_fill``: blocks per pair from the launch's pair count and
sizes, lanes per cell from the graphs' in-degrees).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import native, timings
from .backtrack import mark_alternative_path
from .chase_cuda import (META_FAIL_CHASE, META_FAIL_REP, META_LEN,
                         META_SCORE, N_META, chase, plan_chase, row_width)
from .fill_cuda import (MAX_SLOTS, SMEM_BYTES, FillPlan, card_limits, fill,
                        plan_fill)
from .scores_cuda import exact_s, plan_s, plan_s_prep
from .slots import (COST_INF, EV_CAP, MAX_OFF, TIERS, capped_offset_costs,
                    shb)

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


@functools.lru_cache(maxsize=1 << 12)
def launch_fits(B: int, n1: int, n2: int, dim: int) -> bool:
    """Whether one launch of B pairs of at most n1 x n2 nodes and dim
    states is within the port's kernels: its S and code planes (8 bytes a
    diagonal-major position, n1 x (n1 + n2) positions a pair) within
    LAUNCH_BYTES, and the plans of K1, K2, K3 and X1 for its
    padded shape accepted, each within the shared memory a block may ask
    for.  K3's is taken at one block a pair, its widest band (its rings
    stay in shared memory only where they fit), and X1's at MAX_SLOTS
    slots (its tables' fixed size), so neither the slots nor the reach
    enters."""
    if B * (n1 + n2) * n1 * 8 > LAUNCH_BYTES:
        return False
    n1max = -(-n1 // 8) * 8               # as pack_pairs pads it
    if (plan_fill(B, n1max, MAX_R, blocks_per_pair=1).smem_bytes
            > SMEM_BYTES
            or plan_chase(B, MAX_SLOTS, n1max, n2).smem_bytes > SMEM_BYTES):
        return False
    try:
        plan_s_prep(B, dim, n2)
        plan_s(B, dim, n1max, n2)
    except ValueError:
        return False
    return True


def prep_pair(idx, g1, g2, model, scores):
    """Slot tables for one pair, or the name of its fallback counter."""
    if not launch_fits(1, g1.size, g2.size, g1.dim):
        return "fb_size"
    oc1 = capped_offset_costs(g1, scores, MAX_OFF)
    oc2 = capped_offset_costs(g2, scores, MAX_OFF)
    if oc1 is None or oc2 is None:
        return "fb_offsets"
    (o1, C1, rep1), (o2, C2, rep2) = oc1, oc2
    R = int(o1.max()) + int(o2.max()) + 2
    if R > MAX_R:
        return "fb_reach"
    need = max(len(o1), len(o2))
    width = shb(min(op for op, _ in TIERS if op >= need))
    return PairPrep(idx, g1, g2, model, scores, o1, C1, rep1, o2, C2, rep2,
                    R, width)


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
    # rows of the diagonal-major planes [B, D, n1max] start on a 32-byte
    # sector of device memory (K2 and K3 write them whole)
    n1max = -(-max(p.g1.size for p in preps) // 8) * 8
    n2max = max(p.g2.size for p in preps)
    opmax = max(max(len(p.o1), len(p.o2)) for p in preps)
    g1T, g2T, C1T, C2T, R1T, R2T, cands = _planes(preps, dim, n1max, n2max,
                                                  opmax)
    f32 = np.float32
    M = np.zeros((B, dim, dim), f32)
    pi = np.zeros((B, dim), f32)
    mi = np.zeros(B, f32)
    n1 = np.zeros(B, np.int32)
    n2 = np.zeros(B, np.int32)
    O1 = np.ones((B, opmax), np.int32)
    O2 = np.ones((B, opmax), np.int32)
    iv = np.zeros((B, 8), np.int32)
    par = np.zeros((B, 8), f32)
    for b, p in enumerate(preps):
        a1, a2 = p.g1.size, p.g2.size
        k1, k2 = len(p.o1), len(p.o2)
        M[b] = p.model.M
        pi[b] = p.model.pi
        sc = p.scores
        mi[b] = f32(sc.match_init)
        n1[b], n2[b] = a1, a2
        O1[b, :k1] = p.o1
        O2[b, :k2] = p.o2
        iv[b, :6] = (a1, a2, k1, k2, p.R, p.shb)
        par[b, :7] = (sc.gap_extend, sc.gap_init, sc.start_gap,
                      sc.start_init, sc.end_match, sc.end_gap, sc.end_skip)
    t = lambda a: torch.from_numpy(a).to(device)
    Rmax = max(p.R for p in preps)
    sms, max_blocks = card_limits(device)
    return Batch(t(g1T), t(g2T), t(M), t(pi), t(mi), t(n1), t(n2), t(O1),
                 t(O2), t(C1T), t(C2T), t(R1T), t(R2T), t(iv), t(par),
                 Rmax, n1max + n2max + 8,
                 plan_fill(B, n1max, Rmax, cands, sms=sms,
                           max_blocks=max_blocks))


def _planes(preps, dim, n1max, n2max, opmax):
    """The launch's large planes g1T, g2T, C1T, C2T, R1T, R2T (as
    ``Batch``) and its largest ``_cands_per_cell``: in the native library
    where it loads (one threaded call; the finite slot costs counted as it
    copies them), else ``_planes_numpy``."""
    if native.lib() is None:
        return _planes_numpy(preps, dim, n1max, n2max, opmax)
    *planes, finite = native.pack_planes_native(
        [(p.g1.sites, p.g2.sites, p.C1, p.C2, p.rep1, p.rep2)
         for p in preps], dim, n1max, n2max, opmax, COST_INF)
    cands = max(int(f1) / p.g1.size * int(f2) / p.g2.size
                for (f1, f2), p in zip(finite, preps))
    return (*planes, cands)


def _planes_numpy(preps, dim, n1max, n2max, opmax):
    """``_planes`` in numpy, the path without the native library."""
    B = len(preps)
    f32 = np.float32
    g1T = np.zeros((B, dim, n1max), f32)
    g2T = np.zeros((B, dim, n2max), f32)
    C1T = np.full((B, opmax, n1max), COST_INF, f32)
    C2T = np.full((B, opmax, n2max), COST_INF, f32)
    R1T = np.zeros((B, opmax, n1max), np.uint8)
    R2T = np.zeros((B, opmax, n2max), np.uint8)
    for b, p in enumerate(preps):
        a1, a2 = p.g1.size, p.g2.size
        k1, k2 = len(p.o1), len(p.o2)
        g1T[b, :, :a1] = p.g1.sites.T
        g2T[b, :, :a2] = p.g2.sites.T
        C1T[b, :k1, :a1] = p.C1.T
        C2T[b, :k2, :a2] = p.C2.T
        R1T[b, :k1, :a1] = p.rep1.T
        R2T[b, :k2, :a2] = p.rep2.T
    return (g1T, g2T, C1T, C2T, R1T, R2T,
            max(_cands_per_cell(p) for p in preps))


def run_batch(bt: Batch):
    """S, fill and chase of one launch; the packed [B, W] int32 result
    (still on the batch's device)."""
    Sdiag = exact_s(bt.g1T, bt.g2T, bt.M, bt.pi, bt.mi, bt.n1, bt.n2)
    fo = fill(Sdiag, bt.O1, bt.O2, bt.C1T, bt.C2T, bt.iv, bt.par, bt.Rmax,
              bt.plan)
    return chase(fo, bt.O1, bt.O2, bt.C1T, bt.C2T, bt.R1T, bt.R2T, bt.iv,
                 bt.par, bt.Lm)


def _launches(preps):
    """Cut the size-sorted pairs into launches that each fit the port's
    kernels (``launch_fits``: the padded S and code planes within
    LAUNCH_BYTES, every kernel's plan accepted).  ``prep_pair`` lets
    through only pairs that fit alone, so every launch holds at least
    one."""
    preps = sorted(preps, key=lambda p: -(p.g1.size + p.g2.size))
    out, cur, n1max, n2max = [], [], 0, 0
    for p in preps:
        a, b = max(n1max, p.g1.size), max(n2max, p.g2.size)
        if cur and not launch_fits(len(cur) + 1, a, b, p.g1.dim):
            out.append(cur)
            cur, a, b = [], p.g1.size, p.g2.size
        assert cur or launch_fits(1, a, b, p.g1.dim), \
            "a %d x %d pair past every launch" % (a, b)
        cur.append(p)
        n1max, n2max = a, b
    if cur:
        out.append(cur)
    return out


def align_pairs_device(items, device, mesh=None):
    """Align a batch of (g1, g2, model, scores) on ``device`` (kernels on
    CUDA, their plain versions on the CPU), or split over the shards of
    ``mesh`` (parallel/mesh.py).  Returns, per pair,
    (mapping1, mapping2, score, n_tr_indels) or None (host fallback).
    Under --timings: dp_prep (slot tables), dp_device (packing, copies,
    kernels, the one fetch per launch and, across processes, the gather of
    the rows) and dp_harvest.

    Over a mesh every process preps every pair; the size-sorted pairs are
    dealt round the global shards, each local shard's share is cut into
    launches and packed for its device, every launch is issued before any
    fetch (distinct cards overlap), and every process gathers all rows and
    harvests all pairs, so results and counters are those of one process
    and one shard."""
    from ..parallel.mesh import Mesh

    mesh = mesh or Mesh((device,))
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
        fetched = _gather_rows(_launch_shares(preps, mesh), preps, mesh)
    with timings.phase("dp_harvest"):
        for chunk, packed, Lm in fetched:
            _harvest(chunk, packed, Lm, results)
    return results


def _launch_shares(preps, mesh):
    """Each local shard's share of the size-sorted ``preps`` (dealt round
    the global shards) in launches on its device; every launch issued,
    then each fetched once: [(chunk, packed rows, Lm)]."""
    from ..parallel.mesh import deal, on_device

    order = sorted(preps, key=lambda p: -(p.g1.size + p.g2.size))
    launched = []
    for dev, share in mesh.local(deal(len(order), mesh.size)):
        with on_device(dev):
            for chunk in _launches([order[k] for k in share]):
                bt = pack_pairs(chunk, dev)
                launched.append((chunk, run_batch(bt), bt.Lm))
    return [(chunk, packed.cpu().numpy(), Lm)
            for chunk, packed, Lm in launched]


def _gather_rows(fetched, preps, mesh):
    """Every process's launches (chunks, rows, Lm) in rank order: the
    pairs' indices, (pairs, Lm) per launch and the rows, each one
    ``all_gather`` of int32.  Alone, ``fetched`` as it is."""
    if mesh.world == 1:
        return fetched
    from ..parallel.distributed import all_gather

    idx = np.array([p.idx for chunk, _, _ in fetched for p in chunk],
                   np.int32)
    cuts = np.array([v for chunk, _, Lm in fetched for v in (len(chunk), Lm)],
                    np.int32)
    rows = (np.concatenate([packed.reshape(-1) for _, packed, _ in fetched])
            if fetched else np.zeros(0, np.int32))
    by_idx = {p.idx: p for p in preps}
    out = []
    for idx_r, cuts_r, rows_r in zip(all_gather(idx), all_gather(cuts),
                                     all_gather(rows)):
        at = k = 0
        for n, Lm in cuts_r.reshape(-1, 2).tolist():
            width = n * row_width(Lm)
            out.append(([by_idx[i] for i in idx_r[k:k + n].tolist()],
                        rows_r[at:at + width].reshape(n, -1), Lm))
            at += width
            k += n
    return out


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
