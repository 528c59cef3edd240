"""Antidiagonal wavefront fill of the graph-pair DP (kernel K3,
csrc/fill.cu) and its plain PyTorch version ``fill_torch``.

Replaces the Pallas kernel prographmsa_tpu/align/graph_dp_pallas.py
(_make_kernel).  The source note in csrc/fill.cu says what is carried over
exactly and what the TPU forced and was dropped.  Inputs, batch-padded:
  Sdiag [B, D, n1max] f32       (scores_cuda.exact_s)
  O1, O2 [B, opmax] int32       offsets per slot (padding: 1)
  C1T [B, opmax, n1max], C2T [B, opmax, n2max] f32
                                cost of the slot's edge into each node
                                (COST_INF where there is none)
  iv [B, 8] int32               n1, n2, nl1, nl2, R, shb
  par [B, 8] f32                ge, gi, sg, si, em, eg, es
Outputs (``FillOut``): codes [B, D, n1max] int32, the final rings W/Y/X/M
[B, Rmax, n1max] f32 and the boundary stripes Y[:, 0] [B, n1max] and
X[0, :] [B, n2max].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from prographmsa_tpu.align.graph_dp_pallas import COST_INF, FLOOR, NEG

from .. import _build
from ..device import on_cuda

MAX_SLOTS = 64                  # the kernel's shared offset tables


class FillOut(NamedTuple):
    codes: torch.Tensor
    ringW: torch.Tensor
    ringY: torch.Tensor
    ringX: torch.Tensor
    ringM: torch.Tensor
    stripeY: torch.Tensor
    stripeX: torch.Tensor


def _alloc(B, D, n1max, n2max, Rmax, dev) -> FillOut:
    f32 = torch.float32
    return FillOut(
        torch.zeros((B, D, n1max), dtype=torch.int32, device=dev),
        *(torch.full((B, Rmax, n1max), NEG, dtype=f32, device=dev)
          for _ in range(4)),
        torch.full((B, n1max), NEG, dtype=f32, device=dev),
        torch.full((B, n2max), NEG, dtype=f32, device=dev))


def fill(Sdiag, O1, O2, C1T, C2T, iv, par, Rmax: int) -> FillOut:
    """K3 on CUDA tensors, ``fill_torch`` on CPU tensors."""
    if not on_cuda(Sdiag, O1, O2, C1T, C2T, iv, par):
        return fill_torch(Sdiag, O1, O2, C1T, C2T, iv, par, Rmax)
    B, D, n1max = Sdiag.shape
    opmax, n2max = C2T.shape[1], C2T.shape[2]
    if opmax > MAX_SLOTS:
        raise ValueError("%d offset slots > %d" % (opmax, MAX_SLOTS))
    _build.check_args("fill", (Sdiag, torch.float32, (B, D, n1max)),
                      (O1, torch.int32, (B, opmax)),
                      (O2, torch.int32, (B, opmax)),
                      (C1T, torch.float32, (B, opmax, n1max)),
                      (C2T, torch.float32, (B, opmax, n2max)),
                      (iv, torch.int32, (B, 8)), (par, torch.float32, (B, 8)))
    out = _alloc(B, D, n1max, n2max, Rmax, Sdiag.device)
    threads = min(1024, max(32, (n1max + 31) // 32 * 32))
    L = _build.lib()
    p = _build.ptr
    _build.launch("fill", L.pgm_fill, p(Sdiag), p(O1), p(O2), p(C1T), p(C2T),
                  p(iv), p(par), B, D, n1max, n2max, opmax, Rmax, threads,
                  *(p(t) for t in out))
    return out


def _first_max(cand, valid, code):
    """Strict-improvement max from FLOOR over candidates in visit order:
    cand [B, K, N], valid [B, K], code [B, K] -> (value [B, N], code [B, N]).
    The winner is the first candidate equal to the maximum, as a sequential
    ``if c > acc`` scan finds it; NaN candidates never win."""
    c = torch.where(valid[:, :, None] & ~torch.isnan(cand), cand,
                    torch.tensor(float("-inf"), device=cand.device))
    first = (c == c.amax(dim=1, keepdim=True)).to(torch.uint8).argmax(dim=1)
    val = c.gather(1, first[:, None, :])[:, 0, :]
    win = val > FLOOR
    return (torch.where(win, val, torch.tensor(FLOOR, device=cand.device)),
            torch.where(win, code.gather(1, first), 0))


def _fmax_chain(v, valid):
    """fmax(...fmax(FLOOR, v_0)..., v_K-1) over valid, non-NaN v [B, K, N]."""
    v = torch.where(valid[:, :, None] & ~torch.isnan(v), v,
                    torch.tensor(float("-inf"), device=v.device))
    return torch.clamp(v.amax(dim=1), min=float(FLOOR))


def fill_torch(Sdiag, O1, O2, C1T, C2T, iv, par, Rmax: int) -> FillOut:
    """The plain PyTorch version of K3: the same diagonals, slots, candidate
    op orders and tie-breaks, vectorised over pairs, rows and slots."""
    B, D, n1max = Sdiag.shape
    P, n2max = C2T.shape[1], C2T.shape[2]
    dev = Sdiag.device
    f32 = torch.float32
    out = _alloc(B, D, n1max, n2max, Rmax, dev)
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
    a = torch.arange(P, device=dev)
    i_idx = (nl1[:, None] - 1 - a[None, :]).clamp(min=0)
    j_idx = (nl2[:, None] - 1 - a[None, :]).clamp(min=0)
    ok_i = a[None, :] < nl1[:, None]
    ok_j = a[None, :] < nl2[:, None]
    o1 = O1.long().gather(1, i_idx)
    o2 = O2.long().gather(1, j_idx)
    c1 = C1T.gather(1, i_idx[:, :, None].expand(B, P, n1max))     # [B, P, N]
    c2 = C2T.gather(1, j_idx[:, :, None].expand(B, P, n2max))
    row1 = ys[None, None, :] - o1[:, :, None]                       # y - o1
    okrow1 = row1 >= 0
    row1 = row1.clamp(min=0)
    Wf, Yf, Xf = (r.view(B, Rmax * n1max) for r in (ringW, ringY, ringX))
    two = torch.arange(2, device=dev)
    codeY = ((i_idx[:, :, None] << 1) | two).reshape(B, 2 * P)
    codeX = ((j_idx[:, :, None] << 1) | two).reshape(B, 2 * P)
    codeM = ((i_idx[:, :, None] << shb[:, None, None])
             | j_idx[:, None, :]).reshape(B, P * P)
    okY = ok_i[:, :, None].expand(B, P, 2).reshape(B, 2 * P)
    okX = ok_j[:, :, None].expand(B, P, 2).reshape(B, 2 * P)
    okM = (ok_i[:, :, None] & ok_j[:, None, :]).reshape(B, P * P)
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
                       .expand(B, P, n1max))
        cj = torch.where(xin[:, None, :], cj, cinf)                  # [B, P, N]
        Sd = Sdiag[:, d, :]

        # Y: per slot the Y move, then the W move
        ds = d - o1                                                  # [B, P]
        ok = (ds >= 0)[:, :, None] & okrow1
        k = ds.remainder(R[:, None])
        w = torch.where(ok, ring(Wf, k, row1, (B, P, n1max)), neg)
        yv = torch.where(ok, ring(Yf, k, row1, (B, P, n1max)), neg)
        tge = yv + ge[:, None, None]
        cand = torch.stack([tge - c1, (w + gi[:, None, None]) - c1], 2)
        aY, cY = _first_max(cand.reshape(B, 2 * P, n1max), okY, codeY)
        aYB = _fmax_chain(torch.fmax(tge, w + sg[:, None, None]) - c1, ok_i)

        # M: g1 slots outer, g2 slots inner
        ds2 = d - o1[:, :, None] - o2[:, None, :]                    # [B, P, P]
        ok2 = (ds2 >= 0)[..., None] & okrow1[:, :, None, :]
        k2 = ds2.remainder(R[:, None, None])
        w2 = torch.where(ok2, ring(Wf, k2, row1[:, :, None, :],
                                   (B, P, P, n1max)), neg)
        cand = (((w2 + Sd[:, None, None, :]) - c1[:, :, None, :])
                - cj[:, None, :, :])
        aM, cM = _first_max(cand.reshape(B, P * P, n1max), okM, codeM)

        # X: per slot the X move, then the W move
        ds = d - o2
        ok = (ds >= 0)[:, :, None].expand(B, P, n1max)
        k = ds.remainder(R[:, None])
        rows = ys[None, None, :].expand(B, P, n1max)
        xv = torch.where(ok, ring(Xf, k, rows, (B, P, n1max)), neg)
        wv = torch.where(ok, ring(Wf, k, rows, (B, P, n1max)), neg)
        tge = xv + ge[:, None, None]
        cand = torch.stack([tge - cj, (wv + gi[:, None, None]) - cj], 2)
        aX, cX = _first_max(cand.reshape(B, 2 * P, n1max), okX, codeX)
        aXB = _fmax_chain(torch.fmax(tge, wv + sg[:, None, None]) - cj, ok_j)

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
        codes[:, d, :] = torch.where(act, code, 0).to(torch.int32)
        slot = d % R
        for rg, v in ((ringW, Wr), (ringY, Yr), (ringX, Xr), (ringM, Mr)):
            rg[ar, slot] = torch.where(act, v, rg[ar, slot])
        if d < n1max:
            stripeY[:, d] = torch.where(act[:, d], Yr[:, d], stripeY[:, d])
        if d < n2max:
            stripeX[:, d] = torch.where(act[:, 0] & (d < n2), Xr[:, 0],
                                        stripeX[:, d])
    return out
