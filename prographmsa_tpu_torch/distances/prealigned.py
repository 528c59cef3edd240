"""Pairwise distances from an induced multiple alignment.

Re-derivation of DistanceFactoryPrealigned.h: pairwise
substitution counts read off MSA columns (dual-gap columns skipped, gap
openings counted with a small state machine), then
DistanceFactoryML::computeDistance.

The O(N²·L) column scan is vectorized: per pair, counts come from one
bincount over paired residue codes and gap openings from run-length logic on
the gap masks.  When the engine policy sends the stage to the card, kernel
D1 (distances/prealigned_cuda.py) computes the same integers for every
pair from the alignment uploaded once; a failure there raises, with no
retry on the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .ml import compute_distances_batch


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
    """_pair_stats over ALL pairs at once (same counts/gap semantics).

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


def compute_prealigned_distances(spec, seqs: Dict[str, np.ndarray],
                                 order: List[str], factory, options,
                                 device=None, engine: str = "native"):
    n = len(order)
    distances = np.zeros((n, n))
    variances = np.zeros((n, n))
    # reference counts only residue values < 20 for every alphabet
    # (Prealigned.h:65) — a quirk we keep for AA/codon; DNA uses the correct
    # bound (reference DNA mode is broken, see distances/ml.py docstring).
    count_bound = min(20, spec.DIM) if spec.name != "codon" else 20

    vals = {name: spec.values(seqs[name]) for name in order}
    gapm = {name: spec.is_gap(seqs[name]) for name in order}

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    seqlens = np.zeros(len(pairs))
    for k, (i, j) in enumerate(pairs):
        seqlens[k] = (len(vals[order[i]]) + len(vals[order[j]])) / 2.0

    counts_b = gaps_b = None
    from ..engine_policy import use_device_prealigned
    Lmsa = max((len(vals[name]) for name in order), default=0)
    if pairs and use_device_prealigned(engine, n_pairs=len(pairs), L=Lmsa,
                                       count_bound=count_bound):
        if device is None:
            raise ValueError("engine %r runs the prealigned statistics on "
                             "the card: pass its device" % engine)
        vmat = np.stack([vals[name] for name in order])
        gmat = np.stack([gapm[name] for name in order])
        pi = np.fromiter((i for i, _ in pairs), np.int32, len(pairs))
        pj = np.fromiter((j for _, j in pairs), np.int32, len(pairs))
        counts_b, gaps_b = _pair_stats_on_card(vmat, gmat, pi, pj, spec.DIM,
                                               count_bound, device)
    if counts_b is None and len(pairs) > 8:
        # vectorized host path: ONE bincount over all pairs' column codes
        # plus a forward-filled gap-state scan — replaces the O(N²) Python
        # pair loop (measured ~10x on the fam100 iteration-2/3 stages)
        vmat = np.stack([vals[name] for name in order])
        gmat = np.stack([gapm[name] for name in order])
        pi = np.fromiter((i for i, _ in pairs), np.intp, len(pairs))
        pj = np.fromiter((j for _, j in pairs), np.intp, len(pairs))
        counts_b, gaps_b = _pair_stats_batch_host(vmat, gmat, pi, pj,
                                                  spec.DIM, count_bound)
    if counts_b is None:
        counts_b = np.zeros((len(pairs), spec.DIM, spec.DIM), dtype=np.int64)
        gaps_b = np.zeros(len(pairs), dtype=np.int64)
        for k, (i, j) in enumerate(pairs):
            counts, gaps = _pair_stats(vals[order[i]], gapm[order[i]],
                                       vals[order[j]], gapm[order[j]],
                                       spec.DIM, count_bound)
            counts_b[k] = counts
            gaps_b[k] = gaps
    db, vb = compute_distances_batch(counts_b, gaps_b, seqlens, factory,
                                     options, spec.name)
    for k, (i, j) in enumerate(pairs):
        distances[i, j] = distances[j, i] = db[k]
        variances[i, j] = variances[j, i] = vb[k]
    return distances, variances
