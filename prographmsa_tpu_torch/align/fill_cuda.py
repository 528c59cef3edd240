"""Antidiagonal wavefront fill of the graph-pair DP (kernel K3,
csrc/fill.cu) and its plain PyTorch version ``fill_torch``.

Replaces the Pallas kernel prographmsa_tpu/align/graph_dp_pallas.py
(_make_kernel).  The source note in csrc/fill.cu says what is carried over
exactly and what the design does on this card.  Inputs, batch-padded:
  Sdiag [B, D, n1max] f32       (scores_cuda.exact_s)
  O1, O2 [B, opmax] int32       offsets per slot (padding: 1)
  C1T [B, opmax, n1max], C2T [B, opmax, n2max] f32
                                cost of the slot's edge into each node
                                (COST_INF where there is none)
  iv [B, 8] int32               n1, n2, nl1, nl2, R, shb
  par [B, 8] f32                ge, gi, sg, si, em, eg, es
Outputs (``FillOut``): codes [B, D, n1max] int32, or int64 where opmax is
past NARROW_OFF slots (``slots.wide``, ``code_dtype``: 8-bit slot fields),
the final rings W/Y/X/M [B, Rmax, n1max] f32 and the boundary stripes
Y[:, 0] [B, n1max] and X[0, :] [B, n2max].  Up to MAX_OFF slots a side and
any Rmax below 2^23 (the kernel's edge lists pack an offset into 23 bits).

Only slots with an edge into the node are candidates (cost < COST_INF on
both sides for a match).  An edge-less candidate is about NEG and loses to
every candidate with both edges; with none of those the stored value is
NEG either way.  So this changes no value and no code of a cell whose value
is real, which is every cell a path reaches.  Kernel and plain version mask
the same candidates and agree on whole planes.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import _build
from ..device import on_cuda
from .slots import COST_INF, FLOOR, MAX_OFF, NEG, wide

MAX_RING = 1 << 23              # an edge list entry: slot | offset << 8
MAX_BLOCKS_PER_PAIR = 8         # portable thread block cluster size
WIDE_BLOCKS_PER_PAIR = 16       # non-portable size: only where card_limits
                                # finds that the card can hold it
MAX_THREADS = 1024
SMEM_BYTES = 220 * 1024         # dynamic shared memory a block may ask for
SMS = 132                       # H100 SXM
ROWS_PER_BLOCK = 384            # rows x lanes one block takes before a pair
                                # is spread over more blocks
LANE_THREADS = 768              # a band's rows x lanes stay within this many
                                # threads (larger blocks pay more per barrier)


class FillOut(NamedTuple):
    codes: torch.Tensor
    ringW: torch.Tensor
    ringY: torch.Tensor
    ringX: torch.Tensor
    ringM: torch.Tensor
    stripeY: torch.Tensor
    stripeX: torch.Tensor


class FillPlan(NamedTuple):
    """How one launch of K3 is laid out on the card."""
    blocks_per_pair: int        # cluster size: 1, 2, 4, 8 or 16
    lanes: int                  # threads per cell, a power of two <= 32
    threads: int                # per block
    smem_rings: bool            # W/Y/X rings in (distributed) shared memory
    smem_bytes: int             # dynamic shared memory per block


def _pow2_ceil(x: float) -> int:
    return 1 << (max(1, math.ceil(x)) - 1).bit_length()


def plan_fill(B: int, n1max: int, Rmax: int, cands: float = 1.0,
              blocks_per_pair: int | None = None, lanes: int | None = None,
              sms: int = SMS,
              max_blocks: int = MAX_BLOCKS_PER_PAIR) -> FillPlan:
    """Layout of a launch of B pairs with at most n1max rows, rings of Rmax
    diagonals and about ``cands`` match candidates per cell (the product of
    the two graphs' mean in-degrees).  Chains (``cands`` < 1.5) get one
    lane per cell; merged graphs get twice their mean in lanes, because the
    slowest cell of a diagonal sets its time and the counts are skewed.  A
    pair is spread over more blocks while its rows x lanes exceed
    ROWS_PER_BLOCK per block, the launch still fits the card's ``sms`` SMs
    once and the cluster stays within ``max_blocks`` (``card_limits``).
    The constants come from k3_sweep.py on an H100.  ``blocks_per_pair``
    and ``lanes`` override these choices (checks and measurements only)."""
    lane_threads = LANE_THREADS if lanes is None else MAX_THREADS
    if lanes is None:
        lanes = 1 if cands < 1.5 else min(32, _pow2_ceil(2 * cands))
    C = blocks_per_pair
    if C is None:
        C = 1
        while (C < max_blocks and n1max * lanes > ROWS_PER_BLOCK * C
               and B * C * 2 <= sms):
            C *= 2
    band = -(-n1max // C)
    while lanes > 1 and band * lanes > lane_threads:
        lanes //= 2
    threads = min(MAX_THREADS, max(128, -(-band * lanes // 32) * 32))
    s_bytes = 2 * band * 4
    ring_bytes = 3 * Rmax * band * 4
    smem_rings = s_bytes + ring_bytes <= SMEM_BYTES
    return FillPlan(C, lanes, threads, smem_rings,
                    s_bytes + (ring_bytes if smem_rings else 0))


_card_limits: dict = {}


def card_limits(device) -> tuple:
    """(SMs, largest cluster ``plan_fill`` may use) on ``device``.  A card
    gives its SM count, and WIDE_BLOCKS_PER_PAIR where it can hold such a
    cluster at the largest block the planner asks for, else the portable
    size.  A CPU device gives the H100's SM count and the portable size;
    the plain version ignores the plan."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return SMS, MAX_BLOCKS_PER_PAIR
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _card_limits:
        held = ctypes.c_int(0)
        with torch.cuda.device(idx):
            rc = _build.lib().pgm_fill_max_clusters(
                WIDE_BLOCKS_PER_PAIR, LANE_THREADS, SMEM_BYTES,
                ctypes.byref(held))
        if rc != 0:
            raise RuntimeError("cluster occupancy query failed (%d)" % rc)
        _card_limits[idx] = (
            torch.cuda.get_device_properties(idx).multi_processor_count,
            WIDE_BLOCKS_PER_PAIR if held.value > 0 else MAX_BLOCKS_PER_PAIR)
    return _card_limits[idx]


def code_dtype(opmax: int) -> torch.dtype:
    """The code plane's type for a launch of ``opmax`` slots a side."""
    return torch.int64 if wide(opmax) else torch.int32


def _alloc(B, D, n1max, n2max, Rmax, opmax, dev, filled: bool) -> FillOut:
    """Output tensors: ``filled`` for the plain version, which writes the
    live positions only; the kernel writes every position itself."""
    f32 = torch.float32
    if not filled:
        return FillOut(
            torch.empty((B, D, n1max), dtype=code_dtype(opmax), device=dev),
            *(torch.empty((B, Rmax, n1max), dtype=f32, device=dev)
              for _ in range(4)),
            torch.empty((B, n1max), dtype=f32, device=dev),
            torch.empty((B, n2max), dtype=f32, device=dev))
    return FillOut(
        torch.zeros((B, D, n1max), dtype=code_dtype(opmax), device=dev),
        *(torch.full((B, Rmax, n1max), NEG, dtype=f32, device=dev)
          for _ in range(4)),
        torch.full((B, n1max), NEG, dtype=f32, device=dev),
        torch.full((B, n2max), NEG, dtype=f32, device=dev))


def fill(Sdiag, O1, O2, C1T, C2T, iv, par, Rmax: int,
         plan: FillPlan | None = None) -> FillOut:
    """K3 on CUDA tensors (laid out by ``plan``, default ``plan_fill`` for
    single-candidate cells), ``fill_torch`` on CPU tensors.  The kernel's
    code width follows opmax (``code_dtype``)."""
    if not on_cuda(Sdiag, O1, O2, C1T, C2T, iv, par):
        return fill_torch(Sdiag, O1, O2, C1T, C2T, iv, par, Rmax)
    B, D, n1max = Sdiag.shape
    opmax, n2max = C2T.shape[1], C2T.shape[2]
    if opmax > MAX_OFF:
        raise ValueError("%d offset slots > %d" % (opmax, MAX_OFF))
    if Rmax >= MAX_RING:        # every offset is below R <= Rmax
        raise ValueError("rings of %d diagonals >= %d" % (Rmax, MAX_RING))
    _build.check_args("fill", (Sdiag, torch.float32, (B, D, n1max)),
                      (O1, torch.int32, (B, opmax)),
                      (O2, torch.int32, (B, opmax)),
                      (C1T, torch.float32, (B, opmax, n1max)),
                      (C2T, torch.float32, (B, opmax, n2max)),
                      (iv, torch.int32, (B, 8)), (par, torch.float32, (B, 8)))
    if plan is None:
        plan = plan_fill(B, n1max, Rmax)
    dev = Sdiag.device
    out = _alloc(B, D, n1max, n2max, Rmax, opmax, dev, filled=False)
    # per-node edge lists (slot | offset << 8, cost bits) and their lengths
    E1 = torch.empty((B, opmax, n1max, 2), dtype=torch.int32, device=dev)
    E2 = torch.empty((B, opmax, n2max, 2), dtype=torch.int32, device=dev)
    cnt1 = torch.empty((B, n1max), dtype=torch.int32, device=dev)
    cnt2 = torch.empty((B, n2max), dtype=torch.int32, device=dev)
    L = _build.lib()
    p = _build.ptr
    _build.launch("fill", L.pgm_fill, p(Sdiag), p(O1), p(O2), p(C1T), p(C2T),
                  p(iv), p(par), B, D, n1max, n2max, opmax, Rmax,
                  plan.blocks_per_pair, plan.lanes.bit_length() - 1,
                  plan.threads, int(plan.smem_rings), plan.smem_bytes,
                  p(E1), p(E2), p(cnt1), p(cnt2), *(p(t) for t in out))
    return out


def _first_max(cand, valid, code):
    """Strict-improvement max from FLOOR over candidates in visit order:
    cand [B, K, N], valid [B, K, N], code [B, K] -> (value [B, N],
    code [B, N]).  The winner is the first candidate equal to the maximum,
    as a sequential ``if c > acc`` scan finds it; NaN candidates never win."""
    c = torch.where(valid & ~torch.isnan(cand), cand,
                    torch.tensor(float("-inf"), device=cand.device))
    first = (c == c.amax(dim=1, keepdim=True)).to(torch.uint8).argmax(dim=1)
    val = c.gather(1, first[:, None, :])[:, 0, :]
    win = val > FLOOR
    return (torch.where(win, val, torch.tensor(FLOOR, device=cand.device)),
            torch.where(win, code.gather(1, first), 0))


def _fmax_chain(v, valid):
    """fmax(...fmax(FLOOR, v_0)..., v_K-1) over valid [B, K, N], non-NaN v
    [B, K, N]."""
    v = torch.where(valid & ~torch.isnan(v), v,
                    torch.tensor(float("-inf"), device=v.device))
    return torch.clamp(v.amax(dim=1), min=float(FLOOR))


def fill_torch(Sdiag, O1, O2, C1T, C2T, iv, par, Rmax: int) -> FillOut:
    """The plain PyTorch version of K3: the same diagonals, candidates (the
    slots with an edge into the node), op orders and tie-breaks, vectorised
    over pairs, rows and slots (each side's up to its most slots in the
    batch, P1 and P2: the slots past a pair's own are never candidates)."""
    B, D, n1max = Sdiag.shape
    opmax, n2max = C2T.shape[1], C2T.shape[2]
    dev = Sdiag.device
    f32 = torch.float32
    out = _alloc(B, D, n1max, n2max, Rmax, opmax, dev, filled=True)
    codes, ringW, ringY, ringX, ringM, stripeY, stripeX = out
    iv = iv.long()
    n1, n2, nl1, nl2, R, shb = (iv[:, k] for k in range(6))
    ge, gi, sg, si = (par[:, k] for k in range(4))
    neg = torch.tensor(NEG, dtype=f32, device=dev)
    cinf = torch.tensor(COST_INF, dtype=f32, device=dev)
    ar = torch.arange(B, device=dev)
    ys = torch.arange(n1max, device=dev)
    ringW[:, 0, 0] = si

    # slot visit order: a = 0.. -> slot nl - 1 - a (descending)
    P1, P2 = max(1, int(nl1.max())), max(1, int(nl2.max()))
    a1 = torch.arange(P1, device=dev)
    a2 = torch.arange(P2, device=dev)
    i_idx = (nl1[:, None] - 1 - a1[None, :]).clamp(min=0)
    j_idx = (nl2[:, None] - 1 - a2[None, :]).clamp(min=0)
    ok_i = a1[None, :] < nl1[:, None]
    ok_j = a2[None, :] < nl2[:, None]
    o1 = O1.long().gather(1, i_idx)
    o2 = O2.long().gather(1, j_idx)
    c1 = C1T.gather(1, i_idx[:, :, None].expand(B, P1, n1max))   # [B, P1, N]
    c2 = C2T.gather(1, j_idx[:, :, None].expand(B, P2, n2max))
    row1 = ys[None, None, :] - o1[:, :, None]                       # y - o1
    okrow1 = row1 >= 0
    row1 = row1.clamp(min=0)
    Wf, Yf, Xf = (r.view(B, Rmax * n1max) for r in (ringW, ringY, ringX))
    two = torch.arange(2, device=dev)
    codeY = ((i_idx[:, :, None] << 1) | two).reshape(B, 2 * P1)
    codeX = ((j_idx[:, :, None] << 1) | two).reshape(B, 2 * P2)
    codeM = ((i_idx[:, :, None] << shb[:, None, None])
             | j_idx[:, None, :]).reshape(B, P1 * P2)
    e1 = ok_i[:, :, None] & (c1 < cinf)          # [B, P1, N]: edge into y
    okY = e1[:, :, None, :].expand(B, P1, 2, n1max).reshape(B, 2 * P1,
                                                            n1max)
    dfull = n1 + n2 - 2
    ylive = ys[None, :] < n1[:, None]
    yl = (ys[None, :] >= 1) & (ys[None, :] <= (n1 - 2)[:, None])

    def ring(flat, k, rows, shape):
        idx = (k[..., None] * n1max + rows).reshape(B, -1)
        return flat.gather(1, idx).view(shape)

    for d in range(1, int(dfull.max()) + 1):
        x = d - ys                                                   # [N]
        xin = (x[None, :] >= 0) & (x[None, :] < n2[:, None])         # [B, N]
        cj = c2.gather(2, x.clamp(0, n2max - 1)[None, None, :]
                       .expand(B, P2, n1max))
        cj = torch.where(xin[:, None, :], cj, cinf)                 # [B, P2, N]
        e2 = ok_j[:, :, None] & (cj < cinf)                          # edge into x
        okX = e2[:, :, None, :].expand(B, P2, 2, n1max).reshape(
            B, 2 * P2, n1max)
        okM = (e1[:, :, None, :] & e2[:, None, :, :]).reshape(
            B, P1 * P2, n1max)
        Sd = Sdiag[:, d, :]

        # Y: per slot the Y move, then the W move
        ds = d - o1                                                 # [B, P1]
        ok = (ds >= 0)[:, :, None] & okrow1
        k = ds.remainder(R[:, None])
        w = torch.where(ok, ring(Wf, k, row1, (B, P1, n1max)), neg)
        yv = torch.where(ok, ring(Yf, k, row1, (B, P1, n1max)), neg)
        tge = yv + ge[:, None, None]
        cand = torch.stack([tge - c1, (w + gi[:, None, None]) - c1], 2)
        aY, cY = _first_max(cand.reshape(B, 2 * P1, n1max), okY, codeY)
        aYB = _fmax_chain(torch.fmax(tge, w + sg[:, None, None]) - c1, e1)

        # M: g1 slots outer, g2 slots inner
        ds2 = d - o1[:, :, None] - o2[:, None, :]                  # [B, P1, P2]
        ok2 = (ds2 >= 0)[..., None] & okrow1[:, :, None, :]
        k2 = ds2.remainder(R[:, None, None])
        w2 = torch.where(ok2, ring(Wf, k2, row1[:, :, None, :],
                                   (B, P1, P2, n1max)), neg)
        cand = (((w2 + Sd[:, None, None, :]) - c1[:, :, None, :])
                - cj[:, None, :, :])
        aM, cM = _first_max(cand.reshape(B, P1 * P2, n1max), okM, codeM)

        # X: per slot the X move, then the W move
        ds = d - o2
        ok = (ds >= 0)[:, :, None].expand(B, P2, n1max)
        k = ds.remainder(R[:, None])
        rows = ys[None, None, :].expand(B, P2, n1max)
        xv = torch.where(ok, ring(Xf, k, rows, (B, P2, n1max)), neg)
        wv = torch.where(ok, ring(Wf, k, rows, (B, P2, n1max)), neg)
        tge = xv + ge[:, None, None]
        cand = torch.stack([tge - cj, (wv + gi[:, None, None]) - cj], 2)
        aX, cX = _first_max(cand.reshape(B, 2 * P2, n1max), okX, codeX)
        aXB = _fmax_chain(torch.fmax(tge, wv + sg[:, None, None]) - cj, e2)

        xl = (x[None, :] >= 1) & (x[None, :] <= (n2 - 2)[:, None])
        interior = yl & xl
        bx0 = (x[None, :] == 0) & yl
        by0 = (ys[None, :] == 0) & xl
        Mr = torch.where(interior, aM, neg)
        Xr = torch.where(interior, aX, torch.where(by0, aXB, neg))
        Yr = torch.where(interior, aY, torch.where(bx0, aYB, neg))
        Wr = torch.where(interior, torch.fmax(Mr, torch.fmax(Xr, Yr)),
                         torch.where(bx0, aYB, torch.where(by0, aXB, neg)))
        Mr, Xr, Yr, Wr = (torch.maximum(v, neg) for v in (Mr, Xr, Yr, Wr))
        wst = torch.where(Wr == Mr, 0, torch.where(Wr == Yr, 2, 1))
        s = shb[:, None]
        code = (cM | (cY << (2 * s)) | (cX << (3 * s + 1))
                | (wst << (4 * s + 2)))

        act = ylive & (d <= dfull)[:, None]
        codes[:, d, :] = torch.where(act & xin, code, 0).to(codes.dtype)
        slot = d % R
        for rg, v in ((ringW, Wr), (ringY, Yr), (ringX, Xr), (ringM, Mr)):
            rg[ar, slot] = torch.where(act, v, rg[ar, slot])
        if d < n1max:
            stripeY[:, d] = torch.where(act[:, d], Yr[:, d], stripeY[:, d])
        if d < n2max:
            stripeX[:, d] = torch.where(act[:, 0] & (d < n2), Xr[:, 0],
                                        stripeX[:, d])
    return out
