"""ML pairwise distance estimation.

Re-derivation of DistanceFactoryML.{h,cpp}: initial
p-distance -> Jukes-Cantor-style transform -> Newton-Raphson with bisection
fallback maximizing sum(counts * log P(d)), variance from Fisher information.

Parity notes (reproduced intentionally):
* P(d) inside the Newton iteration is evaluated at the distance *clamped* by
  parseDistance (min_dist/max_dist) while the Newton iterate itself is
  unclamped (DistanceFactoryML.h:91 calling ModelFactory::getModel).
* Count matrices only include residue values < 20 regardless of alphabet
  (DistanceFactoryPrealigned.h:65) — for codon models this discards most
  pairs; for DNA we use the correct < DIM bound since the reference's DNA
  mode is unusable (it crashes; see tools/make_golden.sh).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAXITER = 20
EPSILON = 1e-5

DIST_MAX = {"aa": 2.2, "dna": 2.2, "codon": 5.2}
VAR_MAX = {"aa": 1e3, "dna": 1e3, "codon": 5e3}
VAR_MIN = {"aa": 1e-5, "dna": 1e-5, "codon": 1e-5}


@dataclass
class DistVar:
    dist: float
    var: float


def compute_ml_dist(counts: np.ndarray, gaps: int, seqlen: float,
                    dist0: float, var0: float, factory, options,
                    alphabet_name: str) -> DistVar:
    """Newton/bisection ML distance (DistanceFactoryML.h:67-136)."""
    dist_min = 0.0
    dist_max = np.inf
    dist, var = dist0, var0
    delta = 1.0
    iteration = 0
    c = counts.astype(np.float64)

    while abs(delta) > EPSILON:
        if iteration > MAXITER:
            if dist_max == np.inf:
                dist = DIST_MAX[alphabet_name]
                var = VAR_MAX[alphabet_name]
            else:
                dist = dist0
                var = var0
            break
        model = factory.get_model(dist, options)
        p = model.P
        pp = model.Q @ p
        ppp = model.Q @ pp

        if options.mldist_gap_flag:
            grate = options.indel_rate * seqlen * dist
            g = (-grate + gaps) / dist
            gg = -gaps / (dist * dist)
            f = (c * pp / p).sum() + g
            ff = ((c * (ppp * p - pp * pp)) / (p * p)).sum() + gg
        else:
            f = (c * pp / p).sum()
            ff = ((c * (ppp * p - pp * pp)) / (p * p)).sum()

        var = -1.0 / ff

        if f > 0:
            dist_min = max(dist_min, dist)
        else:
            dist_max = min(dist_max, dist)

        new_dist = dist - f / ff
        if not (new_dist < dist_max and new_dist > dist_min):
            upper = dist * 3 if dist_max == np.inf else dist_max
            new_dist = (upper + dist_min) / 2.0
        delta = 1.0 - new_dist / dist
        dist = new_dist
        iteration += 1

    return DistVar(dist, var)


def _batched_P(factory, dists: np.ndarray) -> np.ndarray:
    """P(d) for a whole batch of distances: ``(V * exp(sigma d)) @ Vi`` with
    the eigendecomposition done once (the expm strategy of ModelFactory.h:62,
    vectorized).  np.matmul over the stacked batch runs the same dgemm per
    slice as the scalar path, so each P is bit-identical to
    ``factory.P_of(d)``."""
    e = np.exp(factory.sigma[None, :] * dists[:, None])          # [B, DIM]
    return np.matmul(factory.V[None, :, :] * e[:, None, :], factory.Vi)


def compute_ml_dist_batch(c: np.ndarray, gaps: np.ndarray, seqlens: np.ndarray,
                          dist0: np.ndarray, var0: np.ndarray, mask: np.ndarray,
                          factory, options, alphabet_name: str):
    """Vectorized Newton/bisection over all pairs at once — the batched form
    of ``compute_ml_dist`` (DistanceFactoryML.h:67-136).  Lane-exact: every
    active lane performs the identical float64 operation sequence as the
    scalar loop, frozen lanes carry their converged values, so results are
    bit-identical to per-pair calls (tests/test_ml_batch.py).

    ``c``: [B, DIM, DIM] float64 counts; ``mask``: lanes that run Newton.
    Returns (dist [B], var [B]) for masked lanes (unmasked lanes return
    dist0/var0 unchanged).
    """
    B = c.shape[0]
    dist = dist0.astype(np.float64).copy()
    var = var0.astype(np.float64).copy()
    dist_min = np.zeros(B)
    dist_max = np.full(B, np.inf)
    active = mask.copy()
    Q = factory.Q
    D = c.shape[1]
    # preallocated work buffers, sliced to the active-lane count each
    # iteration; all elementwise ops run in-place (out=) — the same float64
    # operation per element as the temporary-allocating expression, just
    # without the allocator traffic (this loop is memory-bound).
    buf_c = np.empty_like(c)
    buf_p = np.empty((B, D, D))
    buf_pp = np.empty((B, D, D))
    buf_ppp = np.empty((B, D, D))
    buf_t = np.empty((B, D, D))
    buf_u = np.empty((B, D, D))

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for _ in range(MAXITER + 1):
            if not active.any():
                break
            # Compact to the active lanes: index-gather keeps each
            # [DIM, DIM] slice contiguous, so every per-lane operation
            # (slice-wise dgemm, elementwise, per-slice pairwise sum) is the
            # operation the full-batch — and hence the scalar loop — performs.
            # While most lanes are still active (the first few iterations,
            # always), the gather copies cost more than the wasted lanes
            # they avoid — run full-width then and mask the updates instead;
            # per-lane arithmetic is identical either way.
            a = np.flatnonzero(active)
            full = 2 * len(a) >= B
            if full:
                # compute over every lane, update only the active ones (act)
                act = a
                a = np.arange(B)
                A = B
                da = dist.copy()
                ca = c
            else:
                act = None
                A = len(a)
                da = dist[a]
                ca = np.take(c, a, axis=0, out=buf_c[:A])
            # parse_distance clamp for the model only (ModelFactory.h:104-127);
            # the Newton iterate itself stays unclamped (parity quirk, see
            # module docstring).
            dd = np.maximum(0.0, da)
            dd = np.where(np.isnan(dd), 5.2, dd)
            dd = np.maximum(np.minimum(dd, options.max_dist), options.min_dist)
            e = np.exp(factory.sigma[None, :] * dd[:, None])     # [A, D]
            np.multiply(factory.V[None, :, :], e[:, None, :], out=buf_t[:A])
            p = np.matmul(buf_t[:A], factory.Vi, out=buf_p[:A])  # _batched_P
            pp = np.matmul(Q, p, out=buf_pp[:A])
            ppp = np.matmul(Q, pp, out=buf_ppp[:A])

            # f   = (ca * pp / p).sum(axis=(1, 2))  [+ gap term]
            t = np.multiply(ca, pp, out=buf_t[:A])
            np.divide(t, p, out=t)
            f = t.reshape(A, D * D).sum(axis=1)
            # ff  = ((ca * (ppp*p - pp*pp)) / (p*p)).sum(axis=(1, 2))
            t = np.multiply(ppp, p, out=buf_t[:A])
            u = np.multiply(pp, pp, out=buf_u[:A])
            np.subtract(t, u, out=t)
            np.multiply(ca, t, out=t)
            np.multiply(p, p, out=u)
            np.divide(t, u, out=t)
            ff = t.reshape(A, D * D).sum(axis=1)

            if options.mldist_gap_flag:
                grate = options.indel_rate * seqlens[a] * da
                g = (-grate + gaps[a]) / da
                gg = -gaps[a] / (da * da)
                f = f + g
                ff = ff + gg

            fpos = f > 0
            dmin_new = np.where(fpos, np.maximum(dist_min[a], da), dist_min[a])
            dmax_new = np.where(fpos, dist_max[a], np.minimum(dist_max[a], da))

            new_dist = da - f / ff
            ok = (new_dist < dmax_new) & (new_dist > dmin_new)
            upper = np.where(dmax_new == np.inf, da * 3, dmax_new)
            new_dist = np.where(ok, new_dist, (upper + dmin_new) / 2.0)
            delta = 1.0 - new_dist / da

            if act is not None:     # full-width pass: frozen lanes keep
                a = act             # their converged values
            var[a] = -1.0 / ff[a] if act is not None else -1.0 / ff
            dist_min[a] = dmin_new[a] if act is not None else dmin_new
            dist_max[a] = dmax_new[a] if act is not None else dmax_new
            dist[a] = new_dist[a] if act is not None else new_dist
            # NaN delta exits the scalar while-loop too (abs(nan) > eps is
            # False) — reproduced here.
            d_upd = delta[a] if act is not None else delta
            active[a] = np.abs(d_upd) > EPSILON

    # iteration > MAXITER fallback (DistanceFactoryML.h:73-81)
    fb_hi = dist_max == np.inf
    dist = np.where(active, np.where(fb_hi, DIST_MAX[alphabet_name], dist0),
                    dist)
    var = np.where(active, np.where(fb_hi, VAR_MAX[alphabet_name], var0), var)
    return dist, var


def compute_distances_batch(counts: np.ndarray, gaps: np.ndarray,
                            seqlens: np.ndarray, factory, options,
                            alphabet_name: str):
    """Batched ``compute_distance`` (DistanceFactoryML.h:139-190) over all
    pairs at once: [B, DIM, DIM] counts -> (dist [B], var [B]), bit-identical
    per lane to the scalar function.  Large batches shard across host cores
    (every lane is independent and numpy's dgemm/ufunc inner loops release
    the GIL, so per-lane arithmetic — and hence results — are unchanged)."""
    B = counts.shape[0]
    from .. import native
    nt = native.n_threads()
    if B >= 512 and nt > 1:
        from concurrent.futures import ThreadPoolExecutor

        bounds = np.linspace(0, B, nt + 1).astype(int)
        outs = [None] * nt

        def run(k):
            lo, hi = bounds[k], bounds[k + 1]
            outs[k] = _distances_batch_impl(
                counts[lo:hi], gaps[lo:hi], seqlens[lo:hi], factory,
                options, alphabet_name)

        with ThreadPoolExecutor(nt) as ex:
            list(ex.map(run, range(nt)))
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))
    return _distances_batch_impl(counts, gaps, seqlens, factory, options,
                                 alphabet_name)


def _distances_batch_impl(counts: np.ndarray, gaps: np.ndarray,
                          seqlens: np.ndarray, factory, options,
                          alphabet_name: str):
    c = counts.astype(np.float64)
    ident = np.trace(c, axis1=1, axis2=2)
    total = c.sum(axis=(1, 2))

    dmax = DIST_MAX[alphabet_name]
    vmax = VAR_MAX[alphabet_name]
    vmin = VAR_MIN[alphabet_name]

    with np.errstate(divide="ignore", invalid="ignore"):
        dist0 = np.where(total > 0, 1.0 - ident / total, np.nan)

        if options.mldist_flag or options.mldist_gap_flag:
            bad = (total == 0) | (dist0 > 0.85)
            d_t = np.where(bad, dmax,
                           -np.log(1.0 - dist0 - 0.2 * dist0 * dist0))
            dist = d_t.copy()
            var = np.where(bad, vmax, d_t / total)
            newton = (total > 0) & (ident != total)
            if newton.any():
                dist, var = compute_ml_dist_batch(
                    c, gaps.astype(np.float64), seqlens.astype(np.float64),
                    dist, var, newton, factory, options, alphabet_name)
        else:
            dist = np.where(total == 0, 1.0, dist0)
            var = np.where(total == 0, vmax, dist0 / total)

    over = ~(dist < dmax)
    dist = np.where(over, dmax, dist)
    var = np.where(over, vmax, var)
    dist = np.where(dist > options.cutoff_dist, options.cutoff_dist, dist)
    var = np.where(var < vmin, vmin, var)
    var = np.where(~(var < vmax), vmax, var)
    return dist, var


def compute_distance(counts: np.ndarray, gaps: int, seqlen: float,
                     factory, options, alphabet_name: str) -> DistVar:
    """DistanceFactoryML::computeDistance (DistanceFactoryML.h:139-190)."""
    ident = float(np.trace(counts))
    total = float(counts.sum())
    dist0 = 1.0 - ident / total if total else np.nan

    dmax = DIST_MAX[alphabet_name]
    vmax = VAR_MAX[alphabet_name]
    vmin = VAR_MIN[alphabet_name]

    if options.mldist_flag or options.mldist_gap_flag:
        if total == 0 or dist0 > 0.85:
            dist = dist0 = dmax
            var = vmax
        else:
            dist = dist0 = -np.log(1.0 - dist0 - 0.2 * dist0 * dist0)
            var = dist / total
        if total > 0 and ident != total:
            dv = compute_ml_dist(counts, gaps, seqlen, dist, var, factory,
                                 options, alphabet_name)
            dist, var = dv.dist, dv.var
    else:
        if total == 0:
            dist = dist0 = 1.0
            var = vmax
        else:
            dist = dist0
            var = dist0 / total

    if not (dist < dmax):
        dist = dmax
        var = vmax
    if dist > options.cutoff_dist:
        dist = options.cutoff_dist
    if var < vmin:
        var = vmin
    if not (var < vmax):
        var = vmax
    return DistVar(dist, var)
