"""Pairwise distances from an induced multiple alignment.

Re-derivation of DistanceFactoryPrealigned.h: pairwise
substitution counts read off MSA columns (dual-gap columns skipped, gap
openings counted with a small state machine), then
DistanceFactoryML::computeDistance.

The O(N²·L) column scan streams over blocks of pairs, each taken to its
distances before the next starts, so the stage holds one block's arrays
and never every pair's (at 1,000 rows, 499,500 pairs x 3,516 columns).  On
the host a block is one batch of at most HOST_BLOCK_PAIR_COLUMNS
pair-columns: the native library's threaded column loop
(native/graphcore.cpp gc_pair_stats) where the library loads, else a
vectorized numpy batch (a bincount over the block's paired residue codes,
gap openings by a forward fill of the gap states).  When the
engine policy sends the stage to the card, kernel D1
(distances/prealigned_cuda.py) computes the same integers for a block of
at most CARD_BLOCK_PAIRS pairs a call; a failure there raises, with no
retry on the host.  Counts and gap openings are exact and each pair's
distance is computed lane by lane, so no result depends on the block size.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import native, timings
from .ml import compute_distances_batch

# Pair-columns a block of the host batch: its [pairs, L] temporaries take
# about 50 bytes a pair-column, under a gigabyte a block.
HOST_BLOCK_PAIR_COLUMNS = 1 << 24
# Pairs a call of D1: a re-tree of up to 512 rows (fam500's 124,750 pairs)
# is one call, 1,000 rows' 499,500 pairs are four.
CARD_BLOCK_PAIRS = 1 << 17


def _pair_stats(vals1, gap1, vals2, gap2, dim, count_bound):
    """Counts + gap openings for one aligned pair (Prealigned.h:53-80)."""
    both_res = ~gap1 & ~gap2
    ok = (both_res & (vals1 >= 0) & (vals1 < count_bound)
          & (vals2 >= 0) & (vals2 < count_bound))
    idx = vals1[ok] * count_bound + vals2[ok]
    counts = np.bincount(idx, minlength=count_bound * count_bound).reshape(
        count_bound, count_bound)
    if count_bound < dim:
        full = np.zeros((dim, dim), dtype=counts.dtype)
        full[:count_bound, :count_bound] = counts
        counts = full

    # gap-opening count, vectorized: both-gap columns are transparent
    # (preserve the opened flags); among the remaining columns a gap run
    # opens whenever the column's gap side differs from the previous
    # non-transparent column's state.  (Equivalent to the reference's
    # per-column state machine, Prealigned.h:61-80.)
    state = np.where(both_res, 0, np.where(gap1 & gap2, 1,
                     np.where(~gap1, 2, 3)))
    f = state[state != 1]
    if f.size:
        prev = np.concatenate([[0], f[:-1]])
        gaps = int(((f == 2) & (prev != 2)).sum()
                   + ((f == 3) & (prev != 3)).sum())
    else:
        gaps = 0
    return counts, gaps


def _pair_stats_batch_host(vmat, gmat, pi, pj, dim, count_bound):
    """_pair_stats over the pairs (pi, pj) at once: the native library's
    gc_pair_stats where it loads, else _pair_stats_batch_numpy; the same
    integers either way.  A library that loads and then fails raises."""
    got = native.pair_stats_native(vmat, gmat, pi, pj, dim, count_bound)
    if got is not None:
        return got
    return _pair_stats_batch_numpy(vmat, np.asarray(gmat, dtype=bool), pi,
                                   pj, dim, count_bound)


def _pair_stats_batch_numpy(vmat, gmat, pi, pj, dim, count_bound):
    """_pair_stats over the pairs (pi, pj) at once (same counts/gap
    semantics).

    Counts: one flat bincount of per-pair-offset column codes.  Gap
    openings: the reference's per-column state machine (Prealigned.h:61-80)
    expressed as a forward fill — both-gap columns are transparent, and a
    run opens where a column's state differs from the previous
    non-transparent column's state."""
    cb = count_bound
    v1 = vmat[pi]
    v2 = vmat[pj]
    g1 = gmat[pi]
    g2 = gmat[pj]
    P, L = v1.shape
    both_res = ~g1 & ~g2
    ok = (both_res & (v1 >= 0) & (v1 < cb) & (v2 >= 0) & (v2 < cb))
    base = np.arange(P, dtype=np.int64)[:, None] * (cb * cb)
    code = v1.astype(np.int64) * cb + v2.astype(np.int64) + base
    counts = np.bincount(code[ok], minlength=P * cb * cb)
    counts = counts.reshape(P, cb, cb)
    if cb < dim:
        full = np.zeros((P, dim, dim), dtype=counts.dtype)
        full[:, :cb, :cb] = counts
        counts = full

    state = np.where(both_res, 0, np.where(g1 & g2, 1,
                     np.where(~g1, 2, 3)))
    nt = state != 1
    col = np.arange(L, dtype=np.int64)[None, :]
    prev_idx = np.maximum.accumulate(np.where(nt, col, -1), axis=1)
    prev_idx = np.concatenate(
        [np.full((P, 1), -1, np.int64), prev_idx[:, :-1]], axis=1)
    prev_state = np.where(
        prev_idx >= 0,
        np.take_along_axis(state, np.maximum(prev_idx, 0), axis=1), 0)
    opens = nt & (((state == 2) & (prev_state != 2))
                  | ((state == 3) & (prev_state != 3)))
    return counts, opens.sum(axis=1).astype(np.int64)


def _pair_stats_on_card(vmat, gmat, pi, pj, dim, count_bound, device):
    """D1 on ``device``: counts [P, dim, dim] int64 and gaps [P] int64.
    The card's counts (uint16 below 2^16 columns) go straight into the
    int64 array."""
    import torch

    from .prealigned_cuda import pair_stats

    dev = torch.device(device)
    counts, gaps = pair_stats(
        torch.from_numpy(vmat.astype(np.int32)).to(dev),
        torch.from_numpy(gmat.astype(np.uint8)).to(dev),
        torch.from_numpy(pi.astype(np.int32)).to(dev),
        torch.from_numpy(pj.astype(np.int32)).to(dev), count_bound)
    out = np.zeros((len(pi), dim, dim), dtype=np.int64)
    out[:, :count_bound, :count_bound] = counts.cpu().numpy()
    return out, gaps.cpu().numpy().astype(np.int64)


def host_block_pairs(L: int) -> int:
    """Pairs a block of the host batch over alignments of L columns."""
    return max(1, HOST_BLOCK_PAIR_COLUMNS // max(L, 1))


def compute_prealigned_distances(spec, seqs: Dict[str, np.ndarray],
                                 order: List[str], factory, options,
                                 device=None, engine: str = "native",
                                 block_pairs: int = 0):
    """Distances and variances [n, n] of the aligned rows ``order``: each
    block of pairs (``block_pairs``, else CARD_BLOCK_PAIRS on the card and
    ``host_block_pairs(L)`` on the host) goes from its counts and gap
    openings to its distances before the next block starts."""
    n = len(order)
    distances = np.zeros((n, n))
    variances = np.zeros((n, n))
    # reference counts only residue values < 20 for every alphabet
    # (Prealigned.h:65) — a quirk we keep for AA/codon; DNA uses the correct
    # bound (reference DNA mode is broken, see distances/ml.py docstring).
    count_bound = min(20, spec.DIM) if spec.name != "codon" else 20

    vals = [spec.values(seqs[name]) for name in order]
    gapm = [spec.is_gap(seqs[name]) for name in order]
    lens = np.array([len(v) for v in vals], dtype=np.int64)
    pi, pj = np.triu_indices(n, 1)          # (i, j), i < j, row by row
    seqlens = (lens[pi] + lens[pj]) / 2.0
    P = len(pi)
    if not P:
        return distances, variances

    def finish(sl, counts_b, gaps_b):
        with timings.phase("ml_newton"):
            db, vb = compute_distances_batch(counts_b, gaps_b, seqlens[sl],
                                             factory, options, spec.name)
        distances[pi[sl], pj[sl]] = distances[pj[sl], pi[sl]] = db
        variances[pi[sl], pj[sl]] = variances[pj[sl], pi[sl]] = vb

    from ..engine_policy import use_device_prealigned
    L = int(lens.max())
    if use_device_prealigned(engine, n_pairs=P, L=L,
                             count_bound=count_bound):
        if device is None:
            raise ValueError("engine %r runs the prealigned statistics on "
                             "the card: pass its device" % engine)
        vmat, gmat = np.stack(vals), np.stack(gapm)
        pi32, pj32 = pi.astype(np.int32), pj.astype(np.int32)
        step = block_pairs or CARD_BLOCK_PAIRS
        for s in range(0, P, step):
            sl = slice(s, s + step)
            finish(sl, *_pair_stats_on_card(vmat, gmat, pi32[sl], pj32[sl],
                                            spec.DIM, count_bound, device))
    elif P > 8:
        # int32 values and bool flags: what the native batch takes as is
        vmat, gmat = np.stack(vals).astype(np.int32), np.stack(gapm)
        step = block_pairs or host_block_pairs(L)
        for s in range(0, P, step):
            sl = slice(s, s + step)
            finish(sl, *_pair_stats_batch_host(vmat, gmat, pi[sl], pj[sl],
                                               spec.DIM, count_bound))
    else:
        counts_b = np.zeros((P, spec.DIM, spec.DIM), dtype=np.int64)
        gaps_b = np.zeros(P, dtype=np.int64)
        for k, (i, j) in enumerate(zip(pi, pj)):
            counts_b[k], gaps_b[k] = _pair_stats(vals[i], gapm[i], vals[j],
                                                 gapm[j], spec.DIM,
                                                 count_bound)
        finish(slice(None), counts_b, gaps_b)
    return distances, variances
