"""Pair statistics of a multiple alignment's rows (kernel D1,
csrc/pair_stats.cu: the launches ``pair_pack`` and ``pair_stats``) and
their plain PyTorch versions ``pair_pack_torch`` and ``pair_stats_torch``.

Replaces the XLA program of prographmsa_tpu/distances/prealigned_device.py
(``_make_kernel``).  Inputs: the alignment's values ``vals [N, L]`` int32
and gap mask ``gapm [N, L]`` uint8, uploaded once, and the pair lists
``pi``, ``pj [P]`` int32.  ``pair_pack`` turns the rows once into bit
planes (``G`` gapped, ``K`` counted, as int32 words of 32 columns, and the
counted values ``C`` one byte a column); ``pair_stats`` reads rows pi[p]
and pj[p] of them.  Outputs: ``counts [P, cb, cb]`` (columns where neither
row is gapped and both values are in [0, cb); uint16 where L < 2^16, as
the JAX program fetches them, else int32: ``count_dtype``) and ``gaps
[P]`` int32 (gap openings, with columns gapped in both rows transparent).
Exact integers: the kernels, the plain versions and
``prealigned._pair_stats_batch_host`` agree bit for bit.
"""

from __future__ import annotations

import torch

from .. import _build
from ..device import on_cuda

WARPS = 8                       # pairs per block
PLAIN_PAIRS = 2048              # pairs per batch of pair_stats_torch


def count_dtype(L: int) -> torch.dtype:
    """The counts' type: uint16 holds every count of an alignment shorter
    than 2^16 columns, int32 any other."""
    return torch.uint16 if L < 1 << 16 else torch.int32


def words(L: int) -> int:
    """W, the 32-column words of a packed row."""
    return -(-L // 32)


def pair_pack(vals, gapm, count_bound: int):
    """(G, K, C) of the alignment: the pack launch on CUDA tensors,
    ``pair_pack_torch`` on CPU tensors."""
    if not on_cuda(vals, gapm):
        return pair_pack_torch(vals, gapm, count_bound)
    N, L = vals.shape
    W = words(L)
    _build.check_args("pair_pack", (vals, torch.int32, (N, L)),
                      (gapm, torch.uint8, (N, L)))
    G = torch.empty((N, W), dtype=torch.int32, device=vals.device)
    K = torch.empty_like(G)
    C = torch.empty((N, 32 * W), dtype=torch.uint8, device=vals.device)
    if N * W:
        p = _build.ptr
        _build.launch("pair_pack", _build.lib().pgm_pair_pack, p(vals),
                      p(gapm), N, L, count_bound, p(G), p(K), p(C))
    return G, K, C


def pair_stats(vals, gapm, pi, pj, count_bound: int, packed=None,
               count_type=None):
    """D1 on CUDA tensors (the pack, or the rows ``packed`` already gives,
    then the statistics; counts in ``count_type``, by default
    ``count_dtype(L)``), ``pair_stats_torch`` on CPU tensors."""
    if not on_cuda(vals, gapm, pi, pj):
        return pair_stats_torch(vals, gapm, pi, pj, count_bound)
    N, L = vals.shape
    P = pi.shape[0]
    W = words(L)
    cb = count_bound
    _build.check_args("pair_stats", (pi, torch.int32, (P,)),
                      (pj, torch.int32, (P,)))
    G, K, C = packed if packed is not None else pair_pack(vals, gapm, cb)
    _build.check_args("pair_stats", (G, torch.int32, (N, W)),
                      (K, torch.int32, (N, W)),
                      (C, torch.uint8, (N, 32 * W)))
    dtype = count_type or count_dtype(L)
    if dtype not in (count_dtype(L), torch.int32):
        raise ValueError("pair_stats: %s does not hold the counts of %d "
                         "columns" % (dtype, L))
    counts = torch.empty((P, cb, cb), dtype=dtype, device=vals.device)
    gaps = torch.empty(P, dtype=torch.int32, device=vals.device)
    if P == 0:
        return counts, gaps
    p = _build.ptr
    _build.launch("pair_stats", _build.lib().pgm_pair_stats, p(G), p(K),
                  p(C), p(pi), p(pj), P, W, cb, WARPS,
                  int(dtype == torch.int32), p(counts), p(gaps))
    return counts, gaps


def _bits_to_words(bits):
    """bool [N, 32 W] -> int32 [N, W], bit b of word q = column 32 q + b."""
    N, cols = bits.shape
    w = (bits.view(N, cols // 32, 32).long()
         << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def pair_pack_torch(vals, gapm, count_bound: int):
    """The plain PyTorch version of the pack: padding columns >= L are
    gapped and not counted."""
    N, L = vals.shape
    pad = 32 * words(L) - L
    g = torch.nn.functional.pad(gapm.bool(), (0, pad), value=True)
    v = torch.nn.functional.pad(vals, (0, pad))
    k = ~g & (v >= 0) & (v < count_bound)
    return (_bits_to_words(g), _bits_to_words(k),
            torch.where(k, v, 0).to(torch.uint8))


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
    return counts.to(count_dtype(L)), gaps
