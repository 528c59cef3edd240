"""Exact match-score plane S for a batch of graph pairs, in the fill's
diagonal-major layout (kernels K1 + K2, csrc/scores.cu).

Replaces prographmsa_tpu/align/scores_pallas.py and the shear of
graph_dp_pallas._make_prologue_pallas_fn.  Both the kernels and the plain
version ``exact_s_torch`` replay the host ``precompute_scores``
(align/scores.py) bit for bit: rank-1 accumulation in index order, Eigen's
4-lane packet dots, one rounding per product and sum, IEEE division, the
ls_log bit decode with the column-major body/tail split.  A NaN quotient
(0/0 on the all-zero sentinel rows) is canonicalised to the x86 default NaN
0xFFC00000 first, because the host decodes that NaN into a finite value.

Inputs, batch-padded (B pairs, n1max/n2max nodes, dim states):
  g1T [B, dim, n1max], g2T [B, dim, n2max] f32 (zero beyond each pair's n),
  M [B, dim, dim], pi [B, dim], mi [B] f32 (match_init), n1, n2 [B] int32.
Output Sdiag [B, D, n1max] f32 with D = n1max + n2max - 1:
  Sdiag[b, d, y] = S_b[y, d - y] where that cell exists, else NEG, and
  NaN or < NEG values clamped to NEG (what the fill reads).
"""

from __future__ import annotations

import numpy as np
import torch

from prographmsa_tpu.align.graph_dp_pallas import NEG
from prographmsa_tpu.align.scores import _LS_A, _LS_B, _LS_C

from .. import _build
from ..device import on_cuda

MAX_DIM = 64
_NAN_X86_BITS = -4194304          # 0xFFC00000 as int32


def exact_s(g1T, g2T, M, pi, mi, n1, n2):
    """Sdiag for a batch: K1 then K2 (kernels on CUDA tensors, their plain
    versions on CPU tensors)."""
    t2, v2 = s_prep(g2T, M, pi)
    return s_plane(g1T, t2, v2, pi, mi, n1, n2)


def s_prep(g2T, M, pi):
    """K1: (t2 [B, dim, n2max], v2 [B, n2max])."""
    if not on_cuda(g2T, M, pi):
        return s_prep_torch(g2T, M, pi)
    B, dim, n2max = g2T.shape
    if not 1 <= dim <= MAX_DIM:
        raise ValueError("dim %d outside 1..%d" % (dim, MAX_DIM))
    _build.check_args("s_prep", (g2T, torch.float32, (B, dim, n2max)),
                      (M, torch.float32, (B, dim, dim)),
                      (pi, torch.float32, (B, dim)))
    L = _build.lib()
    t2 = torch.empty((B, dim, n2max), dtype=torch.float32, device=g2T.device)
    v2 = torch.empty((B, n2max), dtype=torch.float32, device=g2T.device)
    p = _build.ptr
    _build.launch("s_prep", L.pgm_s_prep, p(g2T), p(M), p(pi), B, dim, n2max,
                  p(t2), p(v2))
    return t2, v2


def s_plane(g1T, t2, v2, pi, mi, n1, n2):
    """K2: Sdiag [B, n1max + n2max - 1, n1max]."""
    if not on_cuda(g1T, t2, v2, pi, mi, n1, n2):
        return s_plane_torch(g1T, t2, v2, pi, mi, n1, n2)
    B, dim, n1max = g1T.shape
    n2max = t2.shape[2]
    _build.check_args("s", (g1T, torch.float32, (B, dim, n1max)),
                      (t2, torch.float32, (B, dim, n2max)),
                      (v2, torch.float32, (B, n2max)),
                      (pi, torch.float32, (B, dim)),
                      (mi, torch.float32, (B,)), (n1, torch.int32, (B,)),
                      (n2, torch.int32, (B,)))
    D = n1max + n2max - 1
    L = _build.lib()
    Sdiag = torch.empty((B, D, n1max), dtype=torch.float32, device=g1T.device)
    p = _build.ptr
    _build.launch("s", L.pgm_s, p(g1T), p(t2), p(v2), p(pi), p(mi), p(n1),
                  p(n2), B, dim, n1max, n2max, D, float(_LS_A), float(_LS_B),
                  float(_LS_C), p(Sdiag))
    return Sdiag


def _packet_dot(rows, pi):
    """Eigen/SSE dot of rows [B, dim, n] with pi [B, dim] -> [B, n]: four lane
    accumulators, (a0 + a2) + (a1 + a3), then the scalar tail."""
    dim = rows.shape[1]
    k4 = dim & ~3
    zero = torch.zeros_like(rows[:, 0, :])
    acc = [zero, zero, zero, zero]
    for k in range(0, k4, 4):
        for lane in range(4):
            acc[lane] = acc[lane] + rows[:, k + lane, :] * pi[:, k + lane, None]
    res = (acc[0] + acc[2]) + (acc[1] + acc[3])
    for k in range(k4, dim):
        res = res + rows[:, k, :] * pi[:, k, None]
    return res


def exact_s_torch(g1T, g2T, M, pi, mi, n1, n2):
    """The plain PyTorch version of K1 + K2 (same inputs, same output)."""
    return s_plane_torch(g1T, *s_prep_torch(g2T, M, pi), pi, mi, n1, n2)


def s_prep_torch(g2T, M, pi):
    """Plain K1: t2[b, d, x] = sum_k g2[x, k] * M[k, d] in k order, and the
    packet dot v2 = g2 . pi."""
    B, dim, n2max = g2T.shape
    t2 = torch.zeros((B, dim, n2max), dtype=torch.float32, device=g2T.device)
    for k in range(dim):
        t2 = t2 + g2T[:, k, None, :] * M[:, k, :, None]
    return t2, _packet_dot(g2T, pi)


def s_plane_torch(g1T, t2, v2, pi, mi, n1, n2):
    """Plain K2."""
    B, dim, n1max = g1T.shape
    n2max = t2.shape[2]
    dev = g1T.device
    f32 = torch.float32
    # K2 on the plane [B, n1max, n2max]
    num = torch.zeros((B, n1max, n2max), dtype=torch.float32, device=dev)
    for k in range(dim):
        num = num + g1T[:, k, :, None] * t2[:, k, None, :]
    v1 = _packet_dot(g1T, pi)
    den = v1[:, :, None] * v2[:, None, :]
    s = num / den
    nan_x86 = torch.tensor([_NAN_X86_BITS], dtype=torch.int32,
                           device=dev).view(f32)
    s = torch.where(torch.isnan(s), nan_x86, s)
    bits = s.view(torch.int32)
    # logical shifts by masks: torch's int32 >> is arithmetic
    ef = (((bits >> 23) & 0x1FF) - 126).to(torch.float32)
    dm = ((bits & 0x007FFFFF) ^ 0x3F000000).view(torch.float32)
    lsA, lsB, lsC = (torch.tensor(c, dtype=f32, device=dev)
                     for c in (_LS_A, _LS_B, _LS_C))
    q = lsB / (dm - lsC)
    m = mi[:, None, None]
    body = (q + m) + (ef + lsA)
    tail = ((lsA + q) + ef) + m
    ys = torch.arange(n1max, device=dev, dtype=torch.int32)
    xs = torch.arange(n2max, device=dev, dtype=torch.int32)
    n1b, n2b = n1[:, None, None], n2[:, None, None]
    pos = ys[None, :, None] + xs[None, None, :] * n1b
    v = torch.where(pos < ((n1b * n2b) & ~3), body, tail)
    neg = torch.tensor(NEG, dtype=f32, device=dev)
    v = torch.where(torch.isnan(v) | (v < neg), neg, v)
    # shear into the diagonal-major layout: Sdiag[b, d, y] = S[b, y, d - y]
    D = n1max + n2max - 1
    xd = torch.arange(D, device=dev)[:, None] - ys[None, :].long()   # [D, n1max]
    cell = ((xd >= 0) & (xd < n2b.view(B, 1, 1))
            & (ys[None, None, :] < n1b.view(B, 1, 1)))
    gath = torch.gather(
        v, 2, xd.clamp(0, n2max - 1).t()[None].expand(B, n1max, D))
    return torch.where(cell, gath.transpose(1, 2), neg).contiguous()


def unshear(Sdiag, n1: int, n2: int, b: int = 0) -> np.ndarray:
    """Pair b's S plane [n1, n2] back out of the diagonal-major layout."""
    S = Sdiag[b].cpu().numpy()
    y = np.arange(n1)[:, None]
    x = np.arange(n2)[None, :]
    return S[y + x, y]
