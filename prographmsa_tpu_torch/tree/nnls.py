"""Lawson-Hanson active-set non-negative least squares.

Re-derivation of NNLS.h:8-111, including its quirks:
* the fast path returns the unconstrained SVD solution when already >= 0;
* when the newly-activated column solves non-positive, its gradient entry
  is zeroed and the column stays marked active (NNLS.h:80-86);
* variables are deactivated when the line-search lands them at <= 0 *or*
  they are the arg-min of alpha (NNLS.h:98-105).
SVD least-squares solves use numpy lstsq (Eigen uses jacobiSvd; both give
the min-norm LS solution).
"""

from __future__ import annotations

import numpy as np

TOL = 1e-6
MAX_ITER = 100


def _solve(Z: np.ndarray, x: np.ndarray) -> np.ndarray:
    return np.linalg.lstsq(Z, x, rcond=None)[0]


def nnls(Z: np.ndarray, x: np.ndarray) -> np.ndarray:
    Z = np.asarray(Z, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    ncols = Z.shape[1]

    d = _solve(Z, x)
    if d.min() >= 0:
        return d

    P = np.zeros(ncols, dtype=bool)
    d = np.zeros(ncols)
    w = Z.T @ (x - Z @ d)
    w = w * (1.0 - P.astype(np.float64))
    n_iter = 0

    while not P.all() and w.max() > TOL:
        iw = int(np.argmax(w))
        P[iw] = True

        # Reference NNLS.h:36 `if(n_iter++ > MAX_ITER)` tests the
        # PRE-increment value, so it allows one more activation than a
        # naive post-increment check (bails on the 102nd, not the 101st).
        if n_iter > MAX_ITER:
            return d
        n_iter += 1

        while True:
            mapping = np.flatnonzero(P)
            Zp = Z[:, mapping]
            dp = d[mapping]
            iiw = int(np.nonzero(mapping == iw)[0][0])
            sp = _solve(Zp, x)

            if sp.min() > 0:
                d[mapping] = sp
                w = Z.T @ (x - Z @ d)
                w = w * (1.0 - P.astype(np.float64))
                break
            elif sp[iiw] <= 0:
                w[iw] = 0.0
                break

            alpha = dp / (dp - sp)
            alpha[sp > 0] = np.inf
            ia = int(np.argmin(alpha))
            a = alpha[ia]
            dp = dp + a * (sp - dp)
            for k in range(len(dp)):
                if dp[k] <= 0 or k == ia:
                    P[mapping[k]] = False
                    d[mapping[k]] = 0.0
                else:
                    d[mapping[k]] = dp[k]

    return d
