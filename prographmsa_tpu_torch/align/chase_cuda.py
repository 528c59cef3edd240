"""Code-chase traceback of the graph-pair DP (kernel X1, csrc/chase.cu) and
its plain PyTorch version ``chase_torch``.

Replaces the XLA program prographmsa_tpu/align/graph_dp_pallas.py
(_make_chase, _jit_pack).  Inputs: the fill's ``FillOut`` plus the tables
the fill read (O1, O2, C1T, C2T, iv, par) and the repeat-slot flags
R1T [B, opmax, n1max], R2T [B, opmax, n2max] uint8.  Output: one packed
int32 row per pair,
  m1[Lm], m2[Lm]            the mapping in walk order (end first), -2 padded
  meta[4]                   Wend (float32 bits), length, fail_rep, fail_chase
  ev[1 + 4 * EV_CAP]        event count, then sides, next nodes, current
                            nodes and emit positions of the repeat events,
so a batch costs one device-to-host copy.
"""

from __future__ import annotations

import torch

from prographmsa_tpu.align.graph_dp_pallas import BIG, COST_INF, EV_CAP, NEG
from prographmsa_tpu.align.backtrack import STATE_M, STATE_X, STATE_Y

from .. import _build
from ..device import on_cuda
from .fill_cuda import FillOut

META_SCORE, META_LEN, META_FAIL_REP, META_FAIL_CHASE = range(4)
N_META = 4


def row_width(Lm: int) -> int:
    return 2 * Lm + N_META + 1 + 4 * EV_CAP


def chase(fo: FillOut, O1, O2, C1T, C2T, R1T, R2T, iv, par, Lm: int):
    """X1 on CUDA tensors, ``chase_torch`` on CPU tensors."""
    args = (O1, O2, C1T, C2T, R1T, R2T, iv, par)
    if not on_cuda(*fo, *args):
        return chase_torch(fo, *args, Lm)
    B, D, n1max = fo.codes.shape
    Rmax = fo.ringW.shape[1]
    opmax, n2max = C2T.shape[1], C2T.shape[2]
    _build.check_args("chase", (fo.codes, torch.int32, (B, D, n1max)),
                      (fo.ringM, torch.float32, (B, Rmax, n1max)),
                      (fo.ringX, torch.float32, (B, Rmax, n1max)),
                      (fo.ringY, torch.float32, (B, Rmax, n1max)),
                      (fo.stripeY, torch.float32, (B, n1max)),
                      (fo.stripeX, torch.float32, (B, n2max)),
                      (O1, torch.int32, (B, opmax)),
                      (O2, torch.int32, (B, opmax)),
                      (C1T, torch.float32, (B, opmax, n1max)),
                      (C2T, torch.float32, (B, opmax, n2max)),
                      (R1T, torch.uint8, (B, opmax, n1max)),
                      (R2T, torch.uint8, (B, opmax, n2max)),
                      (iv, torch.int32, (B, 8)), (par, torch.float32, (B, 8)))
    out = torch.empty((B, row_width(Lm)), dtype=torch.int32,
                      device=fo.codes.device)
    L = _build.lib()
    p = _build.ptr
    _build.launch("chase", L.pgm_chase, p(fo.codes), p(fo.ringM),
                  p(fo.ringX), p(fo.ringY), p(fo.stripeY), p(fo.stripeX),
                  p(O1), p(O2), p(C1T), p(C2T), p(R1T), p(R2T), p(iv),
                  p(par), B, D, n1max, n2max, opmax, Rmax, Lm, p(out))
    return out


def chase_torch(fo: FillOut, O1, O2, C1T, C2T, R1T, R2T, iv, par, Lm: int):
    """The plain PyTorch version of X1: every pair walks in lockstep, one
    batch of tensor ops per step (the kernel gives each pair a thread)."""
    codes, ringW, ringY, ringX, ringM, stripeY, stripeX = fo
    B, D, n1max = codes.shape
    P, n2max = C2T.shape[1], C2T.shape[2]
    dev = codes.device
    f32 = torch.float32
    iv = iv.long()
    n1, n2, nl1, nl2, R, shb = (iv[:, k] for k in range(6))
    ge, gi, si, em, eg, es = (par[:, k] for k in (0, 1, 3, 4, 5, 6))
    neg = torch.tensor(NEG, dtype=f32, device=dev)
    big = torch.tensor(BIG, dtype=f32, device=dev)
    cinf = torch.tensor(COST_INF, dtype=f32, device=dev)
    smask = (1 << shb) - 1
    dfull = n1 + n2 - 2
    ar = torch.arange(B, device=dev)
    arc = ar[:, None]
    a = torch.arange(P, device=dev)
    i_idx = (nl1[:, None] - 1 - a[None, :]).clamp(min=0)   # descending slots
    j_idx = (nl2[:, None] - 1 - a[None, :]).clamp(min=0)
    ok_i = a[None, :] < nl1[:, None]
    ok_j = a[None, :] < nl2[:, None]
    o1d = O1.long().gather(1, i_idx)
    o2d = O2.long().gather(1, j_idx)
    cdf = codes.view(B, -1)

    def code_at(y, x):
        return cdf.gather(1, ((y + x) * n1max + y)[:, None])[:, 0].long()

    def tail(ring, yy, xx):
        dd = yy + xx
        fe = dfull.view((B,) + (1,) * (yy.dim() - 1))
        Re = R.view(fe.shape)
        ok = ~((yy == 0) & (xx == 0)) & (dd <= fe) & (dd > fe - Re)
        idx = (dd.remainder(Re) * n1max + yy).reshape(B, -1)
        v = ring.view(B, -1).gather(1, idx).view(yy.shape)
        return torch.where(ok, v, neg)

    # ---- end transition
    yp = (n1 - 1)[:, None] - o1d                                 # [B, P]
    xp = (n2 - 1)[:, None] - o2d
    cy = C1T[arc, i_idx, (n1 - 1)[:, None]]
    cx = C2T[arc, j_idx, (n2 - 1)[:, None]]
    yp2 = yp[:, :, None].expand(B, P, P)
    xp2 = xp[:, None, :].expand(B, P, P)
    ypc, xpc = yp2.clamp(min=0), xp2.clamp(min=0)
    cy2, cx2 = cy[:, :, None], cx[:, None, :]
    e3 = (B, 1, 1)
    candM = ((tail(ringM, ypc, xpc) + em.view(e3)) - cy2) - cx2
    candY = ((tail(ringY, ypc, xpc) + eg.view(e3)) - cy2) - cx2
    candX = ((tail(ringX, ypc, xpc) + eg.view(e3)) - cy2) - cx2
    both0 = (yp2 == 0) & (xp2 == 0)
    candS = torch.where(both0, (es.view(e3) - cy2) - cx2, -big)
    valid = ((yp2 >= 0) & (xp2 >= 0) & (cy2 < cinf) & (cx2 < cinf)
             & ok_i[:, :, None] & ok_j[:, None, :])
    c4 = torch.stack([candM, candY, candX, candS], 3)
    v4 = torch.stack([valid, valid, valid, valid & both0], 3)
    Wend = torch.where(v4, c4, -big).reshape(B, -1).amax(1)
    diff = torch.where(v4, (Wend.view(B, 1, 1, 1) - c4).abs(), big)
    k0 = diff.reshape(B, -1).argmin(1)
    t0, ab = k0 % 4, k0 // 4
    a0, b0 = (ab // P)[:, None], (ab % P)[:, None]
    i0, j0 = i_idx.gather(1, a0)[:, 0], j_idx.gather(1, b0)[:, 0]
    y = yp.gather(1, a0)[:, 0].clamp(min=0)
    x = xp.gather(1, b0)[:, 0].clamp(min=0)
    st = torch.where(t0 == 0, STATE_M,
                     torch.where(t0 == 1, STATE_Y, STATE_X))
    y = torch.where(t0 == 3, 0, y)
    x = torch.where(t0 == 3, 0, x)

    m1 = torch.full((B, Lm), -2, dtype=torch.long, device=dev)
    m2 = torch.full((B, Lm), -2, dtype=torch.long, device=dev)
    ev = torch.zeros((B, 4, EV_CAP), dtype=torch.long, device=dev)
    evn = torch.zeros(B, dtype=torch.long, device=dev)
    fail_rep = torch.zeros(B, dtype=torch.bool, device=dev)
    fail_chase = torch.zeros(B, dtype=torch.bool, device=dev)
    pos = torch.ones(B, dtype=torch.long, device=dev)
    m1[:, 0] = n1 - 1
    m2[:, 0] = n2 - 1

    def add_event(side, nxt, cur, cond):
        nonlocal evn, fail_rep
        fail_rep = fail_rep | (cond & (evn >= EV_CAP))
        rec = cond & (evn < EV_CAP)
        at = evn.clamp(max=EV_CAP - 1)
        for r, v in enumerate((torch.full_like(evn, side), nxt, cur, pos)):
            ev[ar, r, at] = torch.where(rec, v, ev[ar, r, at])
        evn = evn + rec.long()

    def push_state(mask, vy, vx, s):
        nonlocal pos
        at = pos.clamp(max=Lm - 1)
        m1[ar, at] = torch.where(mask, torch.where(s == STATE_X, -1, vy),
                                 m1[ar, at])
        m2[ar, at] = torch.where(mask, torch.where(s == STATE_Y, -1, vx),
                                 m2[ar, at])
        pos = pos + mask.long()

    # host order: y-side mark, x-side mark, then the push of (y, x)
    add_event(1, y, n1 - 1, R1T[ar, i0, n1 - 1] > 0)
    add_event(2, x, n2 - 1, R2T[ar, j0, n2 - 1] > 0)
    push_state(((x != 0) | (y != 0)) & ~fail_rep, y, x, st)
    code = code_at(y, x)

    for _ in range(Lm):
        act = ((y != 0) | (x != 0)) & ~fail_rep & ~fail_chase
        if not bool(act.any()):
            break
        isY, isX = st == STATE_Y, st == STATE_X
        on_bx, on_by = x == 0, y == 0
        i_sel = (code >> shb) & smask
        j_sel = code & smask
        rwY = (code >> (2 * shb)) & 1
        iY = (code >> (2 * shb + 1)) & smask
        rwX = (code >> (3 * shb + 1)) & 1
        jX = (code >> (3 * shb + 2)) & smask

        # boundary replays (backtrack.py:140-172) on the exported stripes
        ypb = y[:, None] - o1d
        sy = stripeY.gather(1, ypb.clamp(min=0))
        cyb = C1T[arc, i_idx, y[:, None]]
        okb = (ypb >= 0) & (cyb < cinf) & ok_i
        csY = stripeY[ar, y][:, None]
        dY = torch.stack([
            (csY - ((torch.where(ypb == 0, neg, sy) + ge[:, None]) - cyb)).abs(),
            (csY - ((torch.where(ypb == 0, si[:, None], sy) + gi[:, None])
                    - cyb)).abs()], 2)
        kB = torch.where(okb[:, :, None], dY, big).reshape(B, -1).argmin(1)
        xq = x.clamp(max=n2max - 1)
        xpb = xq[:, None] - o2d
        sx = stripeX.gather(1, xpb.clamp(min=0))
        cxb = C2T[arc, j_idx, xq[:, None]]
        okb2 = (xpb >= 0) & (cxb < cinf) & ok_j
        csX = stripeX[ar, xq][:, None]
        dX = torch.stack([
            (csX - ((torch.where(xpb == 0, neg, sx) + ge[:, None]) - cxb)).abs(),
            (csX - ((torch.where(xpb == 0, si[:, None], sx) + gi[:, None])
                    - cxb)).abs()], 2)
        kB2 = torch.where(okb2[:, :, None], dX, big).reshape(B, -1).argmin(1)
        iB = i_idx.gather(1, (kB // 2)[:, None])[:, 0]
        jB = j_idx.gather(1, (kB2 // 2)[:, None])[:, 0]

        i_sel = torch.where(isY, torch.where(on_bx, iB, iY), i_sel)
        j_sel = torch.where(isX, torch.where(on_by, jB, jX), j_sel)
        rw = torch.where(isY, torch.where(on_bx, kB % 2, rwY),
                         torch.where(isX, torch.where(on_by, kB2 % 2, rwX), 1))
        bad = act & ((~isX & (i_sel >= nl1)) | (~isY & (j_sel >= nl2)))
        fail_chase = fail_chase | bad
        act = act & ~bad
        ic, jc = i_sel.clamp(max=P - 1), j_sel.clamp(max=P - 1)
        ny = torch.where(isX, y, (y - O1.long()[ar, ic]).clamp(min=0))
        nx = torch.where(isY, x, (x - O2.long()[ar, jc]).clamp(min=0))
        rep1 = torch.where(isX, 0, R1T[ar, ic, y].long())
        rep2 = torch.where(isY, 0, R2T[ar, jc, xq].long())
        add_event(1, ny, y, act & (rep1 > 0))
        add_event(2, nx, x, act & (rep2 > 0))
        act = act & ~fail_rep
        code2 = code_at(ny, nx)
        nst = torch.where(rw == 1, (code2 >> (4 * shb + 2)) & 3,
                          torch.where(isY, STATE_Y, STATE_X))
        live = (ny != 0) | (nx != 0)
        full = act & live & (pos >= Lm - 1)
        fail_chase = fail_chase | full
        act = act & ~full
        push_state(act & live, ny, nx, nst)
        y = torch.where(act, ny, y)
        x = torch.where(act, nx, x)
        st = torch.where(act, nst, st)
        code = torch.where(act, code2, code)

    fail_chase = fail_chase | (~fail_rep & ((y != 0) | (x != 0)))
    done = ~fail_rep & ~fail_chase
    push_state(done, torch.zeros_like(y), torch.zeros_like(x),
               torch.full_like(st, STATE_M))
    meta = torch.stack([Wend.contiguous().view(torch.int32).long(), pos,
                        fail_rep.long(), fail_chase.long()], 1)
    return torch.cat([m1, m2, meta, evn[:, None], ev.reshape(B, -1)],
                     1).to(torch.int32)
