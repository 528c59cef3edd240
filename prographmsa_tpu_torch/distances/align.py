"""All-pairs Needleman-Wunsch distances (--nwdist).

Re-derivation of DistanceFactoryAlign.{h,cpp}: global affine-gap alignment
with hardcoded BLOSUM64-style integer matrices, then ML distance from the
match counts.

The port's copy of prographmsa_tpu/distances/align.py.  The batched fill
+ backtrack runs on the card as kernel D2 (distances/nw_cuda.py) when the
engine policy says so, else on the threaded native host kernel
(``native.nw_counts_native``); both give exact integers.  On the card a
failure raises: there is no retry on the host, nor, over a mesh, from the
shards to one card (a failed shard raises in its process, and its peers on
the process group's timeout).  The host-backtrack oracle
of the JAX package (``_batched_W``, ``_make_scan``) is not ported.
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
    return np.ascontiguousarray(np.load(_DATA)[name], dtype=np.int32)


def _seq_codes(spec, seq: np.ndarray) -> np.ndarray:
    """value(); invalid -> 20 (reference quirk also for codon,
    DistanceFactoryAlign.h:71-79)."""
    v = spec.values(seq).astype(np.int32)
    v[v < 0] = 20
    return v


def compute_nw_distances(spec, seqs: Dict[str, np.ndarray], order: List[str],
                         factory, options, device=None,
                         engine: str = "native", batch_pairs: int = 0,
                         mesh=None):
    """All-pairs NW distances: counts and gap openings of every pair, in
    chunks, then the ML distance per pair on the host.  On the card
    (``engine_policy.use_device_nw``) the codes go up once to each shard's
    device, a chunk (``batch_pairs``, else as many pairs as each shard's
    launch of D2 holds in its scratch) is split over the shards of ``mesh``
    (parallel/mesh.py; None: ``device`` alone), and the host's ML Newton of
    a chunk overlaps the next chunk's kernels; on the host a chunk is
    ``batch_pairs`` (2048) pairs of the native kernel."""
    from .. import native, timings
    from ..engine_policy import use_device_nw

    n = len(order)
    scoring = _load_scoring(spec.name)
    go, ge = GAP_PARAMS[spec.name]
    codes = [_seq_codes(spec, seqs[name]) for name in order]
    lens = np.array([len(c) for c in codes], dtype=np.int32)
    L = int(lens.max()) if n else 0
    code_dt = np.uint8 if scoring.shape[0] <= 256 else np.int32
    cmat = np.zeros((n, max(L, 1)), dtype=code_dt)
    for i, c in enumerate(codes):
        cmat[i, :len(c)] = c
    T = scoring.shape[0]
    if cmat.max() >= T:
        # a code the table does not hold (20, an invalid residue, against
        # the 5 x 5 DNA table) scores 0, as under the JAX device program's
        # one-hot lookup: one zero row and column, every such code onto it
        scoring = np.pad(scoring, ((0, 1), (0, 1)))
        cmat = np.minimum(cmat, T).astype(code_dt)
    pi, pj = np.triu_indices(n, 1)          # (i, j), i < j, row by row
    seqlens = (lens[pi] + lens[pj]) / 2.0
    distances = np.zeros((n, n))
    variances = np.zeros((n, n))

    def finish(sl, counts_b, gaps_b):
        with timings.phase("ml_newton"):
            db, vb = compute_distances_batch(
                np.asarray(counts_b, dtype=np.int64),
                np.asarray(gaps_b, dtype=np.int64), seqlens[sl], factory,
                options, spec.name)
        distances[pi[sl], pj[sl]] = distances[pj[sl], pi[sl]] = db
        variances[pi[sl], pj[sl]] = variances[pj[sl], pi[sl]] = vb

    P = len(pi)
    if not P:
        return distances, variances
    if use_device_nw(engine, P, L, spec.DIM):
        if device is None and mesh is None:
            raise ValueError("engine %r runs NW on the card: pass its "
                             "device" % engine)
        from ..parallel.mesh import Mesh
        from .nw_cuda import pairs_per_pass
        mesh = mesh or Mesh((device,))
        _nw_on_card(cmat, lens, pi, pj, scoring, go, ge, spec.DIM, mesh,
                    batch_pairs or pairs_per_pass(L, L, mesh.devices[0])
                    * mesh.size, finish)
        return distances, variances
    chunk = batch_pairs or 2048
    for s in range(0, P, chunk):
        sl = slice(s, s + chunk)
        res = native.nw_counts_native(cmat[pi[sl]], cmat[pj[sl]],
                                      lens[pi[sl]], lens[pj[sl]], scoring,
                                      go, ge, spec.DIM)
        if res is None:
            raise RuntimeError("--nwdist on the host needs the native host "
                               "library (g++)")
        finish(sl, *res)
    return distances, variances


def _nw_on_card(cmat, lens, pi, pj, scoring, go, ge, dim, mesh, chunk,
                finish):
    """D2 over the pairs in chunks, each chunk's pairs split over the
    shards of ``mesh`` (a one-shard mesh: the run's device): each shard's
    counts come back by an asynchronous copy, every process gathers every
    shard's, and ``finish`` (the host ML) of a chunk runs while the next
    chunk's kernels do."""
    import torch

    from ..parallel.sharded import gather_split, launch_split
    from .nw_cuda import nw_counts

    score_range = (int(scoring.min()), int(scoring.max()))
    uploads = {}

    def run(dev, lo, hi):
        if dev not in uploads:
            uploads[dev] = [torch.from_numpy(a).to(dev) for a in (
                cmat, lens, scoring, pi.astype(np.int64), pj.astype(np.int64))]
        cm, ln, sc, pit, pjt = uploads[dev]
        a, b = pit[lo:hi], pjt[lo:hi]
        return nw_counts(cm[a], cm[b], ln[a], ln[b], sc, go, ge, dim,
                         score_range=score_range)

    outs = (((dim, dim), np.int32), ((), np.int32))
    pending = None
    for s in range(0, len(pi), chunk):
        out = launch_split(
            mesh, min(chunk, len(pi) - s),
            lambda dev, idx, s=s: run(dev, s + int(idx[0]),
                                      s + int(idx[-1]) + 1))
        if pending is not None:
            finish(pending[0], *gather_split(pending[1], outs))
        pending = (slice(s, s + chunk), out)
    finish(pending[0], *gather_split(pending[1], outs))
