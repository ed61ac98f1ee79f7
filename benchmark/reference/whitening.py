"""The Laplace whitening the NUTS mixes sample in, worked out again from the
reference's own Hessian.

The sampler runs in ``v`` with ``u = c + v A``: ``c`` the generating point,
``A = H^{-1/2}`` of the Hessian ``H`` of the negative log-joint at ``c``
(saddle-free: ``|curvature|``, floored at 1e-6 of the stiffest), so a
density and its gradient at a visited ``v`` are the density at ``u`` and
``A`` times its u-gradient.  ``H`` is taken here by central differences of
the reference gradient, with the same step as the program's.
"""

from __future__ import annotations

import numpy as np

#: central-difference step of the Hessian, in u
HESSIAN_STEP = 1e-4


def hessian(problem, c, h=HESSIAN_STEP) -> np.ndarray:
    """Symmetrized Hessian of ``problem.nll`` at ``c`` (float64 numpy)."""
    dim = c.size
    H = np.empty((dim, dim))
    for i in range(dim):
        e = np.zeros(dim)
        e[i] = h
        H[:, i] = (problem.nll(c + e)[1] - problem.nll(c - e)[1]) / (2 * h)
    return 0.5 * (H + H.T)


def whitening(H) -> np.ndarray:
    """``A = |H|^{-1/2}`` with the curvature floored at 1e-6 of the stiffest."""
    w, V = np.linalg.eigh(np.asarray(H, dtype=np.float64))
    w = np.maximum(np.abs(w), 1e-6 * max(float(np.max(np.abs(w))), 1e-30))
    return (V * (1.0 / np.sqrt(w))[None, :]) @ V.T
