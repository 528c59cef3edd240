"""Alignment-free k-mer ("angle") distances.

Re-derivation of DistanceFactoryAngle.h as one batched count + GEMM: count
all DIM^K k-mers per sequence, cosine similarity of the count vectors via a
single matmul, then the distance transform (DistanceFactoryAngle.h:115-128).

The port's copy of prographmsa_tpu/distances/angle.py.
``compute_angle_distances`` is the float64 parity path (matches the
reference's double-precision Eigen GEMM, whose rounding decides NJ
tie-breaks); ``compute_angle_distances_device`` takes the Gram of the
integer counts as one float32 product on the card (the ``device`` engine
only, engine_policy.use_device_angle).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .. import native

def kmer_counts(spec, seqs: Dict[str, np.ndarray], order: List[str],
                k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding k-mer index counting (DistanceFactoryAngle.h:61-96).

    Returns (counts[N, DIM**k] float64, seq_len[N]).
    A k-mer containing any invalid residue is skipped.
    """
    dim = spec.DIM
    n = len(order)
    counts = np.zeros((n, dim ** k), dtype=np.float64)
    seq_len = np.zeros(n, dtype=np.int64)
    weights = dim ** np.arange(k - 1, -1, -1)
    for i, name in enumerate(order):
        vals = spec.values(seqs[name]).astype(np.int64)
        seq_len[i] = len(vals)
        valid = (vals >= 0) & (vals < dim)
        vals = np.where(valid, vals, 0)
        if len(vals) < k:
            continue
        # windows[j] = index of k-mer ending at j+k-1
        idx = np.zeros(len(vals) - k + 1, dtype=np.int64)
        ok = np.ones(len(vals) - k + 1, dtype=bool)
        for t in range(k):
            idx += vals[t:len(vals) - k + 1 + t] * weights[t]
            ok &= valid[t:len(vals) - k + 1 + t]
        np.add.at(counts[i], idx[ok], 1.0)
    return counts, seq_len


def _distance_transform(cos: np.ndarray, seq_len: np.ndarray, options):
    """cosine-similarity matrix -> (distances, variances)
    (DistanceFactoryAngle.h:116-128)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        d = -np.log((np.square(cos) + 0.4) / 1.4)
        if not options.mldist_flag and not options.mldist_gap_flag:
            e = np.exp(d)
            d = -0.5 * (5.0 * e - np.sqrt(45.0 * e * e - 20.0 * e)) / e
        lens = np.broadcast_to(seq_len.astype(np.float64), (len(seq_len),
                                                            len(seq_len)))
        var = 2.0 / (lens + lens.T)
        var = var * d
    var = np.maximum(var, 1e-5)
    return d, var


def compute_angle_distances(spec, seqs: Dict[str, np.ndarray],
                            order: List[str], options):
    """Host float64 parity path.

    Follows Eigen's evaluation order exactly (DistanceFactoryAngle.h:115 is
    ``((D⁻¹·Cᵀ)·C)·D⁻¹`` left-associated): rows are scaled by 1/norm
    *before* the GEMM, and the GEMM accumulates sequentially over k — the
    rounding determines NJ tie-breaks, so this makes guide trees
    bit-identical to the reference binary.  The native library's Gram
    keeps those products and that order of adds."""
    counts, seq_len = kmer_counts(spec, seqs, order, spec.kmer_k)
    C = counts.T                               # [DIM^K, N] like counts2
    sq = (C * C).sum(axis=0)                   # exact integers
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_norm = 1.0 / np.sqrt(sq)
        G = native.angle_gram_native(counts, inv_norm)
        if G is None:
            scaled = inv_norm[:, None] * C.T   # [N, DIM^K] row-scaled
            n = len(order)
            G = np.empty((n, n))
            for i in range(n):
                # sequential-k accumulation (cumsum rounds like a scalar
                # loop)
                G[i, :] = np.cumsum(scaled[i][:, None] * C, axis=0)[-1]
        cos = G * inv_norm[None, :]
    return _distance_transform(cos, seq_len, options)


def compute_angle_distances_device(spec, seqs: Dict[str, np.ndarray],
                                   order: List[str], options, device):
    """The k-mer count Gram as one float32 ``torch.matmul`` on ``device``
    (TF32 off), then the JAX package's host float64 normalisation and
    transform.  The Gram of integer counts is exact in float32 while its
    sums stay below 2^24, so the result equals the JAX package's device
    path bit for bit.  It is not the host path's: that one scales the rows
    before an Eigen-ordered product, and NJ breaks ties on the last bit."""
    import torch

    from ..device import full_float32

    counts, seq_len = kmer_counts(spec, seqs, order, spec.kmer_k)
    full_float32()
    C = torch.from_numpy(counts.astype(np.float32)).to(device)
    G = torch.matmul(C, C.T).cpu().numpy().astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / np.sqrt(np.diag(G))
        cos = G * inv[:, None] * inv[None, :]
    return _distance_transform(cos, seq_len, options)
