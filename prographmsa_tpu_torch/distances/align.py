"""All-pairs Needleman-Wunsch distances (--nwdist).

Re-derivation of DistanceFactoryAlign.{h,cpp}: global affine-gap alignment
with hardcoded BLOSUM64-style integer matrices, then ML distance from the
match counts.

The port's copy of prographmsa_tpu/distances/align.py with the host path
only: the batched fill + backtrack is the threaded native kernel
(``native.nw_counts_native``, exact integers).  The device program
(distances/nw_device.py there) is still to be ported.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from .ml import compute_distances_batch

_DATA = os.path.join(os.path.dirname(__file__), "..", "models", "data",
                     "nw_scoring.npz")

MINFTY = -10000
GAP_PARAMS = {"aa": (-10, -2), "codon": (-10, -2), "dna": (-5, -2)}


def _load_scoring(name: str) -> np.ndarray:
    return np.load(_DATA)[name].astype(np.int32)


def _seq_codes(spec, seq: np.ndarray) -> np.ndarray:
    """value(); invalid -> 20 (reference quirk also for codon,
    DistanceFactoryAlign.h:71-79)."""
    v = spec.values(seq).astype(np.int32)
    v[v < 0] = 20
    return v


def compute_nw_distances(spec, seqs: Dict[str, np.ndarray], order: List[str],
                         factory, options, batch_pairs: int = 2048):
    """All-pairs NW distances: counts and gap openings from the native host
    kernel in chunks of ``batch_pairs``, then the ML distance per pair."""
    from .. import native, timings

    n = len(order)
    scoring = _load_scoring(spec.name)
    go, ge = GAP_PARAMS[spec.name]
    codes = {name: _seq_codes(spec, seqs[name]) for name in order}
    lens = {name: len(codes[name]) for name in order}

    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    distances = np.zeros((n, n))
    variances = np.zeros((n, n))

    L1 = max(lens.values())
    code_dt = np.uint8 if scoring.shape[0] <= 256 else np.int32
    for start in range(0, len(pairs), batch_pairs):
        chunk = pairs[start:start + batch_pairs]
        B = len(chunk)
        s1b = np.zeros((B, L1), dtype=code_dt)
        s2b = np.zeros((B, L1), dtype=code_dt)
        l1 = np.zeros(B, dtype=np.int32)
        l2 = np.zeros(B, dtype=np.int32)
        for b, (i, j) in enumerate(chunk):
            c1, c2 = codes[order[i]], codes[order[j]]
            s1b[b, :len(c1)] = c1
            s2b[b, :len(c2)] = c2
            l1[b], l2[b] = len(c1), len(c2)
        res = native.nw_counts_native(s1b, s2b, l1, l2, scoring, go, ge,
                                      spec.DIM)
        if res is None:
            raise RuntimeError("--nwdist needs the native host library "
                               "(g++); its device program is not ported yet")
        counts_b, gaps_b = res
        seqlens = np.array([(lens[order[i]] + lens[order[j]]) / 2.0
                            for (i, j) in chunk])
        with timings.phase("ml_newton"):
            db, vb = compute_distances_batch(
                np.asarray(counts_b[:B], dtype=np.int64),
                np.asarray(gaps_b[:B], dtype=np.int64), seqlens, factory,
                options, spec.name)
        for b, (i, j) in enumerate(chunk):
            distances[i, j] = distances[j, i] = db[b]
            variances[i, j] = variances[j, i] = vb[b]
    return distances, variances
