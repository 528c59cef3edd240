"""All-pairs Needleman-Wunsch fill and backtrack (kernel D2, csrc/nw.cu)
and its plain PyTorch version ``nw_torch``.

Replaces the XLA program of prographmsa_tpu/distances/nw_device.py
(``_make_kernel``).  Inputs: codes ``s1b [B, L1]`` and ``s2b [B, L2]``
(uint8, or int32 for a table over 256 codes), lengths ``l1``, ``l2 [B]``,
the ``[T, T]`` int32 scoring table (row from sequence 2, column from
sequence 1; every code < T, which the caller ensures: the kernel indexes
the table in shared memory unchecked; every entry in -128 .. 127, which
``plan_nw`` checks: the kernel's score profile is int8), the gap open and
extension scores and ``dim``.  Outputs:
``counts [B, dim, dim]`` int32 (counts[s1, s2] of the aligned residue
pairs with both codes < dim) and ``gaps [B]`` int32 (gap openings).  Exact
integers: the kernel, ``nw_torch`` and ``native.nw_counts_native`` agree
bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..device import on_cuda

MINFTY = -10000
SCRATCH_BYTES = 1 << 29         # backtrack bits of one launch on the card
PLAIN_BYTES = 1 << 28           # W and X planes of one nw_torch pass
WARPS = 8                       # pairs per block, at most
MIN_BLOCKS = 132                # fewer pairs a block below a block an SM
SMEM_MAX = 232448               # dynamic shared memory a block may use
ROWS = (1, 2, 4)                # rows a lane the kernel is compiled for


class NWPlan(NamedTuple):
    """One launch of D2: ``warps`` pairs per block, ``smem_bytes`` of
    dynamic shared memory per block, ``pairs`` per launch, ``rows`` rows a
    lane (strips of 32 ``rows``, a pair's last one maybe narrower: see
    csrc/nw.cu); ``walk`` False only in the fill-only
    variant nw_sweep.py times (counts and gaps then come out 0)."""
    warps: int
    smem_bytes: int
    pairs: int
    rows: int
    walk: bool = True


def _code_ints(L: int, code_bytes: int) -> int:
    return (L * code_bytes + 3) // 4


def bits_per_pair(L1: int, L2: int, rows: int) -> int:
    """Bytes of backtrack bits a pair needs: 2 bits a cell, a row's steps 0
    .. L1 + 31 at 16 a word, the rows padded to whole strips of 32
    ``rows``."""
    S = 32 * rows
    return 4 * (-(-L2 // S) * S) * ((L1 + 47) // 16)


def plan_nw(B: int, T: int, L1: int, L2: int, dim: int, score_range,
            code_bytes: int = 1, warps: int = WARPS, rows: int = 0,
            walk: bool = True) -> NWPlan:
    """Layout of D2 for B pairs of at most L1 x L2 residues under a table
    whose entries run over ``score_range`` (lo, hi): the scoring table
    and, per warp, two row buffers of L1 + 1, the histogram, the score
    profile (32 words a code) and both sequences' codes in shared memory;
    at most ``rows`` rows a lane (0: 4; a pair's last strip may take
    fewer, which makes 4 no slower than 2 or 1 on nw_sweep.py's shapes);
    up to ``warps``
    pairs a block, fewer where the block would not fit or B pairs would
    give fewer blocks than MIN_BLOCKS (the H100's SMs); as many pairs per
    launch as SCRATCH_BYTES of bits hold.  Raises where the table does not
    fit the profile's int8 or one warp's share does not fit a block."""
    lo, hi = (int(v) for v in score_range)
    if lo < -128 or hi > 127:
        raise ValueError("NW scoring table runs from %d to %d; D2's score "
                         "profile holds int8 (-128 to 127)" % (lo, hi))
    rows = rows or max(ROWS)
    if rows not in ROWS:
        raise ValueError("NW: %d rows a lane, not one of %s" % (rows, ROWS))
    per_warp = 4 * (2 * (L1 + 1) + dim * dim + 32 * T
                    + _code_ints(L1, code_bytes) + _code_ints(L2, code_bytes))
    while warps > 1 and (4 * T * T + warps * per_warp > SMEM_MAX
                         or -(-B // warps) < MIN_BLOCKS):
        warps //= 2
    smem = 4 * T * T + warps * per_warp
    if smem > SMEM_MAX:
        raise ValueError("NW pair of %d x %d residues needs %d bytes of "
                         "shared memory, more than a block has"
                         % (L1, L2, smem))
    pairs = max(1, min(B, SCRATCH_BYTES
                       // max(1, bits_per_pair(L1, L2, rows))))
    return NWPlan(warps, smem, pairs, rows, walk)


def pairs_per_pass(L1: int, L2: int, device) -> int:
    """Pairs whose scratch fits one pass on ``device``: the kernel's bits on
    the card, nw_torch's W and X planes on the CPU."""
    if torch.device(device).type == "cuda":
        return max(1, SCRATCH_BYTES
                   // max(1, bits_per_pair(L1, L2, max(ROWS))))
    return max(1, PLAIN_BYTES // (8 * (L1 + L2) * (L2 + 1)))


def nw_counts(s1b, s2b, l1, l2, scoring, go: int, ge: int, dim: int,
              plan: NWPlan | None = None, score_range=None):
    """D2 on CUDA tensors, in launches of ``plan.pairs`` pairs sharing one
    scratch; ``nw_torch`` on CPU tensors.  Without a ``plan`` the launch
    is planned here, from ``score_range`` (the table's (min, max)) or, where
    that is not given, from the table itself: a read that waits for the
    card, so a caller that times or captures calls passes either."""
    if not on_cuda(s1b, s2b, l1, l2, scoring):
        return nw_torch(s1b, s2b, l1, l2, scoring, go, ge, dim)
    B, L1 = s1b.shape
    L2 = s2b.shape[1]
    T = scoring.shape[0]
    if s1b.dtype not in (torch.uint8, torch.int32):
        raise ValueError("nw: codes must be uint8 or int32, got %s"
                         % s1b.dtype)
    _build.check_args("nw", (s1b, s1b.dtype, (B, L1)),
                      (s2b, s1b.dtype, (B, L2)), (l1, torch.int32, (B,)),
                      (l2, torch.int32, (B,)),
                      (scoring, torch.int32, (T, T)))
    dev = s1b.device
    counts = torch.empty((B, dim, dim), dtype=torch.int32, device=dev)
    gaps = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return counts, gaps
    code_bytes = s1b.element_size()
    if plan is None:
        if score_range is None:
            score_range = scoring.aminmax()
        plan = plan_nw(B, T, L1, L2, dim, score_range, code_bytes)
    bits = torch.empty(min(B, plan.pairs) * bits_per_pair(L1, L2, plan.rows)
                       // 4, dtype=torch.int32, device=dev)
    p = _build.ptr
    for s in range(0, B, plan.pairs):
        n = min(plan.pairs, B - s)
        _build.launch("nw", _build.lib().pgm_nw, p(s1b[s:s + n]),
                      p(s2b[s:s + n]), p(l1[s:s + n]), p(l2[s:s + n]),
                      p(scoring), T, go, ge, dim, n, L1, L2, code_bytes,
                      plan.rows, plan.warps, int(plan.walk), plan.smem_bytes,
                      p(bits), p(counts[s:s + n]), p(gaps[s:s + n]))
    return counts, gaps


def nw_torch(s1b, s2b, l1, l2, scoring, go: int, ge: int, dim: int):
    """The plain PyTorch version of D2, the JAX program's algorithm: one
    batch of tensor ops per anti-diagonal keeps W and X of every cell
    ([D, B, L2 + 1], diagonal-major), then every pair walks back in
    lockstep, one batch of ops per step."""
    dev = s1b.device
    s1 = s1b.long()
    s2 = s2b.long()
    sc = scoring.int()
    B, L1 = s1.shape
    L2 = s2.shape[1]
    D, H = L1 + L2, L2 + 1
    i32 = torch.int32
    ys = torch.arange(H, device=dev)
    bnd_y = go + (ys - 1) * ge
    minf = torch.tensor(MINFTY, dtype=i32, device=dev)
    Wdg = torch.empty((D, B, H), dtype=i32, device=dev)
    Xdg = torch.empty((D, B, H), dtype=i32, device=dev)
    Wm1 = torch.full((B, H), MINFTY, dtype=i32, device=dev)
    Wm1[:, 0] = 0
    Wm2 = torch.full((B, H), MINFTY, dtype=i32, device=dev)
    Xm1 = torch.full((B, H), MINFTY, dtype=i32, device=dev)
    Ym1 = torch.full((B, H), MINFTY, dtype=i32, device=dev)
    yi = (ys - 1).clamp(min=0)
    for d in range(1, D + 1):
        xs = d - ys
        score = sc[s2[:, yi], s1[:, (xs - 1).clamp(0, L1 - 1)]]
        newX = torch.maximum(Xm1 + ge, Wm1 + go)
        newY = torch.maximum(torch.roll(Ym1, 1, 1) + ge,
                             torch.roll(Wm1, 1, 1) + go)
        newW = torch.maximum(torch.roll(Wm2, 1, 1) + score,
                             torch.maximum(newX, newY))
        y0 = (ys == 0)[None, :]
        x0 = (xs == 0)[None, :]
        bx = (go + (xs - 1) * ge).to(i32)[None, :]
        by = bnd_y.to(i32)[None, :]
        newW = torch.where(y0, bx, torch.where(x0, by, newW))
        newX = torch.where(y0, bx, torch.where(x0, minf, newX))
        newY = torch.where(y0, minf, torch.where(x0, by, newY))
        oob = ((xs < 0) | (xs > L1))[None, :]
        newW = torch.where(oob, minf, newW)
        newX = torch.where(oob, minf, newX)
        newY = torch.where(oob, minf, newY)
        Wdg[d - 1] = newW
        Xdg[d - 1] = newX
        Wm2, Wm1, Xm1, Ym1 = Wm1, newW, newX, newY

    bidx = torch.arange(B, device=dev)
    y, x = l2.long().clone(), l1.long().clone()
    go1 = torch.zeros(B, dtype=torch.bool, device=dev)
    go2 = torch.zeros(B, dtype=torch.bool, device=dev)
    counts = torch.zeros((B, dim * dim + 1), dtype=i32, device=dev)
    gaps = torch.zeros(B, dtype=i32, device=dev)
    for _ in range(D):
        active = (y > 0) & (x > 0)
        yc, xc = y.clamp(min=1), x.clamp(min=1)
        w = Wdg[yc + xc - 1, bidx, yc]
        dd = yc + xc - 2
        wd = torch.where(dd == 0, 0, Wdg[(dd - 1).clamp(0, D - 1), bidx,
                                         yc - 1])
        s1c = s1[bidx, xc - 1]
        s2c = s2[bidx, yc - 1]
        diag = w == wd + sc[s2c, s1c]
        xmv = ~diag & (w == Xdg[yc + xc - 1, bidx, yc])
        ymv = ~diag & ~xmv
        valid = active & diag & (s1c < dim) & (s2c < dim)
        counts[bidx, torch.where(valid, s1c * dim + s2c, dim * dim)] += 1
        gaps += (active & ((xmv & ~go1) | (ymv & ~go2))).to(i32)
        go1 = torch.where(active, xmv, go1)
        go2 = torch.where(active, ymv, go2)
        y = torch.where(active & (diag | ymv), y - 1, y)
        x = torch.where(active & (diag | xmv), x - 1, x)
    return counts[:, :dim * dim].reshape(B, dim, dim), gaps
