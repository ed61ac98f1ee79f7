"""Gauss-Legendre quadrature grids (numpy + scipy, host-side), copied from
``gpcsd_tpu.ops.quadrature``.

The reference builds its rule once per covariance object with
``scipy.special.roots_legendre`` rescaled to the integration interval
(``covariances.py:22-27`` for 1D, ``:113-131`` for the 2D tensor grid).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy.special import roots_legendre

from ..utils.grids import expand_grid


class QuadRule(NamedTuple):
    """Nodes and weights of a fixed quadrature rule on an interval."""

    x: np.ndarray  # (n,) nodes
    w: np.ndarray  # (n,) weights


def gauss_legendre(a: float, b: float, n: int) -> QuadRule:
    """Gauss-Legendre rule with n nodes rescaled from [-1, 1] to [a, b]."""
    x, w = roots_legendre(n)
    half = 0.5 * (b - a)
    return QuadRule(x=half * (x + 1.0) + a, w=half * w)


class QuadRule2D(NamedTuple):
    """Tensor-product rule on [a1,b1] x [a2,b2] flattened to a point list
    (dim-2 fastest, matching the reference ``expand_grid`` ordering)."""

    xy: np.ndarray  # (n1*n2, 2)
    w: np.ndarray  # (n1*n2,)
    rule1: QuadRule
    rule2: QuadRule


def gauss_legendre_2d(a1, b1, a2, b2, n1: int, n2: int) -> QuadRule2D:
    r1 = gauss_legendre(a1, b1, n1)
    r2 = gauss_legendre(a2, b2, n2)
    xy = expand_grid(r1.x, r2.x)
    w = np.prod(expand_grid(r1.w, r2.w), axis=1)
    return QuadRule2D(xy=xy, w=w, rule1=r1, rule2=r2)
