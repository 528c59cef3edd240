"""Pair statistics of a multiple alignment's rows (kernel D1,
csrc/pair_stats.cu) and its plain PyTorch version ``pair_stats_torch``.

Replaces the XLA program of prographmsa_tpu/distances/prealigned_device.py
(``_make_kernel``).  Inputs: the alignment's values ``vals [N, L]`` int32
and gap mask ``gapm [N, L]`` uint8, uploaded once, and the pair lists
``pi``, ``pj [P]`` int32; the kernel reads rows pi[p] and pj[p] itself.
Outputs: ``counts [P, cb, cb]`` int32 (columns where neither row is gapped
and both values are in [0, cb)) and ``gaps [P]`` int32 (gap openings, with
columns gapped in both rows transparent).  Exact integers: the kernel,
``pair_stats_torch`` and ``prealigned._pair_stats_batch_host`` agree bit
for bit.  Counts in int32 hold any alignment shorter than 2^31 columns.
"""

from __future__ import annotations

import torch

from .. import _build
from ..device import on_cuda

WARPS = 8                       # pairs per block
PLAIN_PAIRS = 2048              # pairs per batch of pair_stats_torch


def pair_stats(vals, gapm, pi, pj, count_bound: int):
    """D1 on CUDA tensors, ``pair_stats_torch`` on CPU tensors."""
    if not on_cuda(vals, gapm, pi, pj):
        return pair_stats_torch(vals, gapm, pi, pj, count_bound)
    N, L = vals.shape
    P = pi.shape[0]
    cb = count_bound
    _build.check_args("pair_stats", (vals, torch.int32, (N, L)),
                      (gapm, torch.uint8, (N, L)), (pi, torch.int32, (P,)),
                      (pj, torch.int32, (P,)))
    counts = torch.empty((P, cb, cb), dtype=torch.int32, device=vals.device)
    gaps = torch.empty(P, dtype=torch.int32, device=vals.device)
    if P == 0:
        return counts, gaps
    p = _build.ptr
    _build.launch("pair_stats", _build.lib().pgm_pair_stats, p(vals),
                  p(gapm), p(pi), p(pj), P, L, cb, WARPS, p(counts), p(gaps))
    return counts, gaps


def pair_stats_torch(vals, gapm, pi, pj, count_bound: int):
    """The plain PyTorch version of D1, in batches of PLAIN_PAIRS pairs:
    counts as a masked one-hot ``bmm`` in float32 (exact below 2^24
    columns), gap openings as the host batch path's forward fill of the
    last non-transparent column's state."""
    cb = count_bound
    dev = vals.device
    P, L = pi.shape[0], vals.shape[1]
    counts = torch.zeros((P, cb, cb), dtype=torch.int32, device=dev)
    gaps = torch.zeros(P, dtype=torch.int32, device=dev)
    col = torch.arange(L, device=dev)
    for s in range(0, P, PLAIN_PAIRS):
        ii, jj = pi[s:s + PLAIN_PAIRS].long(), pj[s:s + PLAIN_PAIRS].long()
        v1, v2 = vals[ii], vals[jj]
        g1, g2 = gapm[ii].bool(), gapm[jj].bool()

        def onehot(v, g):
            ok = ~g & (v >= 0) & (v < cb)
            oh = torch.nn.functional.one_hot(
                torch.where(ok, v, cb).long(), cb + 1)[..., :cb]
            return oh.to(torch.float32)

        counts[s:s + PLAIN_PAIRS] = torch.bmm(
            onehot(v1, g1).transpose(1, 2), onehot(v2, g2)).to(torch.int32)
        # state 0 both residues, 1 both gapped (transparent), 2 gap in row
        # j only, 3 gap in row i only
        both_res = ~g1 & ~g2
        state = torch.where(both_res, 0, torch.where(
            g1 & g2, 1, torch.where(~g1, 2, 3)))
        nt = state != 1
        prev = torch.cummax(torch.where(nt, col, -1), dim=1).values
        prev = torch.cat([torch.full_like(prev[:, :1], -1), prev[:, :-1]], 1)
        prev_state = torch.where(prev >= 0, state.gather(1, prev.clamp(min=0)),
                                 0)
        opens = nt & (((state == 2) & (prev_state != 2))
                      | ((state == 3) & (prev_state != 3)))
        gaps[s:s + PLAIN_PAIRS] = opens.sum(1).to(torch.int32)
    return counts, gaps
