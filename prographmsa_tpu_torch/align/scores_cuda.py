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

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..device import on_cuda
from .fill_cuda import SMS
from .scores import _LS_A, _LS_B, _LS_C
from .slots import NEG

MAX_DIM = 64
_NAN_X86_BITS = -4194304          # 0xFFC00000 as int32
_LS = (float(_LS_A), float(_LS_B), float(_LS_C))
DGROUPS = (8, 4, 2, 1)            # outputs d per thread K1 is compiled for
XVECS = (4, 1)                    # nodes x per thread (4: 16-byte loads)
FILL_THREADS = 128                # a launch fills the card when it has this
                                  # many threads for every SM
S_THREADS = (128, 64)             # rows y per block K2 takes
S_CHAINS = 4                      # diagonals a thread of K2 runs at a time
S_DTILES = (64, 32, 16, 8)        # diagonals per block the planner picks from
S_FIXED_DIMS = (4, 20, 61, MAX_DIM)   # widths K2 keeps a g1 row in registers
                                      # for (DNA, protein, codons, the widest)
S_SMEM_MAX = 48 * 1024            # bytes of shared memory a block of K2 gets
S_FILL_TILES = 6                  # a launch fills the card when this many
                                  # tiles per SM touch the pairs' bands


class SPrepPlan(NamedTuple):
    """How one launch of K1 is laid out on the card: a grid of
    (x-tiles, d-groups, pairs) blocks of ``threads`` threads, a thread
    owning ``xvec`` neighbouring nodes x and ``dgroup`` outputs d."""
    threads: int
    dgroup: int
    xvec: int
    grid: tuple


@functools.lru_cache(maxsize=256)
def plan_s_prep(B: int, dim: int, n2max: int, sms: int = SMS,
                dgroup: int | None = None,
                xvec: int | None = None) -> SPrepPlan:
    """Layout of K1 for B pairs of n2max nodes and dim states.  A thread
    takes as many chains (dgroup x xvec) as still leave FILL_THREADS threads
    for every one of the card's ``sms`` SMs, so that a launch of one small
    pair spreads over the card and a large launch runs long interleaved
    chains; 16-byte loads along x (xvec 4) need n2max to be a multiple of 4
    and are preferred at equal work per thread.  ``dgroup`` and ``xvec``
    override the choice (checks and measurements only)."""
    if not 1 <= dim <= MAX_DIM:
        raise ValueError("dim %d outside 1..%d" % (dim, MAX_DIM))
    xvecs = [v for v in XVECS if v == 1 or n2max % 4 == 0]
    if xvec is not None:
        if xvec not in xvecs:
            raise ValueError("xvec %d with n2max %d" % (xvec, n2max))
        xvecs = [xvec]
    if dgroup is not None and dgroup not in DGROUPS:
        raise ValueError("dgroup %d not in %s" % (dgroup, DGROUPS))
    dgroups = [g for g in DGROUPS
               if g == 1 or g < 2 * dim] if dgroup is None else [dgroup]

    def n_threads(g, v):
        return B * -(-dim // g) * -(-n2max // v)

    layouts = sorted(((g, v) for v in xvecs for g in dgroups),
                     key=lambda gv: (-gv[0] * gv[1], -gv[1]))
    g, v = next((gv for gv in layouts
                 if n_threads(*gv) >= sms * FILL_THREADS), layouts[-1])
    nx = -(-n2max // v)
    threads = min(128, max(32, 1 << (nx - 1).bit_length()))
    return SPrepPlan(threads, g, v, (-(-nx // threads), -(-dim // g), B))


class SPlan(NamedTuple):
    """How one launch of K2 is laid out on the card: a grid of
    (y-tiles, d-tiles, pairs) blocks, a block owning ``threads`` rows y and
    ``dtile`` diagonals d, a thread one row, walking the tile's diagonals
    S_CHAINS at a time; ``smem_bytes`` of shared memory hold the tile's
    window of t2 and v2 (and, at a width not in S_FIXED_DIMS, its g1)."""
    threads: int
    dtile: int
    grid: tuple
    smem_bytes: int


def s_col_floats(dim: int) -> int:
    """Floats per column of K2's window (t2[0..dim), v2, padding): 4 more
    than a multiple of 8 where the width is compiled in (16-byte reads free
    of bank conflicts), else odd (4-byte reads free of them)."""
    return (dim + 4) // 8 * 8 + 4 if dim in S_FIXED_DIMS else (dim + 1) | 1


def s_smem_bytes(dim: int, threads: int, dtile: int) -> int:
    """Shared memory of one block of K2: ``threads - 1 + dtile`` window
    columns (dtile rounded up to whole groups of S_CHAINS), and the
    block's g1 tile where the width is not compiled in."""
    cols = threads - 1 + -(-dtile // S_CHAINS) * S_CHAINS
    g1 = 0 if dim in S_FIXED_DIMS else dim * threads
    return 4 * (g1 + cols * s_col_floats(dim))


@functools.lru_cache(maxsize=256)
def plan_s(B: int, dim: int, n1max: int, n2max: int, sms: int = SMS,
           threads: int | None = None,
           dtile: int | None = None) -> SPlan:
    """Layout of K2 for B pairs of n1max x n2max nodes and dim states.
    ``threads``: the most rows per block whose last y-tile is still at least
    half rows of the plane.  ``dtile``: the most diagonals per block (they
    share one load of the thread's g1 row, one v1 and one window fill) that
    fit the shared memory and still leave S_FILL_TILES tiles on the pairs'
    bands for every one of the card's ``sms`` SMs, so that a launch of one
    pair spreads over the card.  ``threads`` and ``dtile`` override the
    choice (checks and measurements only)."""
    if not 1 <= dim <= MAX_DIM:
        raise ValueError("dim %d outside 1..%d" % (dim, MAX_DIM))
    if threads is not None and threads not in S_THREADS:
        raise ValueError("threads %d not in %s" % (threads, S_THREADS))
    if dtile is not None and dtile < 1:
        raise ValueError("dtile %d" % dtile)
    if threads is None:
        threads = next((t for t in S_THREADS
                        if 2 * (n1max - (-(-n1max // t) - 1) * t) >= t),
                       S_THREADS[-1])
    ytiles = -(-n1max // threads)
    D = n1max + n2max - 1
    if dtile is None:
        fits = [d for d in S_DTILES
                if s_smem_bytes(dim, threads, d) <= S_SMEM_MAX]
        band = lambda d: B * ytiles * -(-(n2max + threads - 1) // d)
        dtile = next((d for d in fits if band(d) >= S_FILL_TILES * sms),
                     fits[-1])
    smem = s_smem_bytes(dim, threads, dtile)
    grid = (ytiles, -(-D // dtile), B)
    if smem > S_SMEM_MAX:
        raise ValueError("dtile %d with %d threads and dim %d needs %d bytes "
                         "of shared memory (limit %d)"
                         % (dtile, threads, dim, smem, S_SMEM_MAX))
    if max(grid[1:]) > 65535:
        raise ValueError("grid %s" % (grid,))
    return SPlan(threads, dtile, grid, smem)


def exact_s(g1T, g2T, M, pi, mi, n1, n2, pdl: bool = True,
            plan: SPlan | None = None):
    """Sdiag for a batch: K1 then K2, from one call into the library and one
    workspace for t2 and v2 on CUDA tensors, K2 laid out by ``plan``
    (default ``plan_s``) as K1's programmatic dependent (``pdl`` False, a
    plain second launch, is for checks and measurements only); their plain
    versions on CPU tensors."""
    if not on_cuda(g1T, g2T, M, pi, mi, n1, n2):
        return exact_s_torch(g1T, g2T, M, pi, mi, n1, n2)
    B, dim, n1max = g1T.shape
    n2max = g2T.shape[2]
    f32 = torch.float32
    _build.check_args("exact_s", (g1T, f32, (B, dim, n1max)),
                      (g2T, f32, (B, dim, n2max)), (M, f32, (B, dim, dim)),
                      (pi, f32, (B, dim)), (mi, f32, (B,)),
                      (n1, torch.int32, (B,)), (n2, torch.int32, (B,)))
    prep = plan_s_prep(B, dim, n2max)
    if plan is None:
        plan = plan_s(B, dim, n1max, n2max)
    D = n1max + n2max - 1
    ws = torch.empty(B * (dim + 1) * n2max, dtype=f32, device=g1T.device)
    Sdiag = torch.empty((B, D, n1max), dtype=f32, device=g1T.device)
    p = _build.ptr
    _build.launch(("s_prep", "s"), _build.lib().pgm_exact_s, p(g1T), p(g2T),
                  p(M), p(pi), p(mi), p(n1), p(n2), B, dim, n1max, n2max, D,
                  *_LS, prep.threads, prep.dgroup, prep.xvec, int(pdl),
                  plan.threads, plan.dtile, p(ws), p(Sdiag))
    return Sdiag


def s_prep(g2T, M, pi, plan: SPrepPlan | None = None):
    """K1: (t2 [B, dim, n2max], v2 [B, n2max]), laid out by ``plan``
    (default ``plan_s_prep``)."""
    if not on_cuda(g2T, M, pi):
        return s_prep_torch(g2T, M, pi)
    B, dim, n2max = g2T.shape
    _build.check_args("s_prep", (g2T, torch.float32, (B, dim, n2max)),
                      (M, torch.float32, (B, dim, dim)),
                      (pi, torch.float32, (B, dim)))
    if plan is None:
        plan = plan_s_prep(B, dim, n2max)
    t2 = torch.empty((B, dim, n2max), dtype=torch.float32, device=g2T.device)
    v2 = torch.empty((B, n2max), dtype=torch.float32, device=g2T.device)
    p = _build.ptr
    _build.launch("s_prep", _build.lib().pgm_s_prep, p(g2T), p(M), p(pi), B,
                  dim, n2max, plan.threads, plan.dgroup, plan.xvec, p(t2),
                  p(v2))
    return t2, v2


def s_plane(g1T, t2, v2, pi, mi, n1, n2, plan: SPlan | None = None):
    """K2: Sdiag [B, n1max + n2max - 1, n1max], laid out by ``plan``
    (default ``plan_s``)."""
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
    if plan is None:
        plan = plan_s(B, dim, n1max, n2max)
    D = n1max + n2max - 1
    Sdiag = torch.empty((B, D, n1max), dtype=torch.float32, device=g1T.device)
    p = _build.ptr
    _build.launch("s", _build.lib().pgm_s, p(g1T), p(t2), p(v2), p(pi),
                  p(mi), p(n1), p(n2), B, dim, n1max, n2max, D, *_LS,
                  plan.threads, plan.dtile, p(Sdiag))
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
