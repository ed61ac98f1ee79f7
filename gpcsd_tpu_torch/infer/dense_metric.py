"""Dense (full-covariance) NUTS metric building blocks.

Counterpart of ``gpcsd_tpu.infer.dense_metric``: Stan's ``dense_e``
ingredients as plain functions.

- :func:`dense_welford_init` / :func:`dense_welford_update` /
  :func:`dense_welford_merge` / :func:`dense_welford_cov`: streaming
  full-covariance estimate with Stan's shrinkage toward a scaled identity.
- :func:`metric_from_cov`: Cholesky factor ``L`` with ``Sigma = L L^T``;
  the mass matrix is ``M = Sigma^{-1}``.
- :func:`draw_momentum` (``r ~ N(0, M)``), :func:`velocity`
  (``M^{-1} r = Sigma r``), :func:`kinetic` (``0.5 r^T Sigma r``).

Conventions match the diagonal path in ``infer/hmc.py`` (inv_mass is the
posterior covariance estimate).  The sampler uses the Welford functions
only: ``infer/hmc.py`` handles a dense ``inv_mass`` itself, by its rank.
The Cholesky-factor functions (:func:`metric_from_cov`,
:func:`draw_momentum`, :func:`velocity`, :func:`kinetic`) are kept as the
counterparts of the JAX package's and are held to them by the tests.  Every function takes leading batch axes
(one state per chain) before the ``dim`` axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config


class DenseWelfordState(NamedTuple):
    count: torch.Tensor  # (...,) float64
    mean: torch.Tensor  # (..., dim)
    m2: torch.Tensor  # (..., dim, dim) sum of outer products of residuals


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def dense_welford_init(dim: int, batch=(), dtype=torch.float64,
                       device=config.DEFAULT_DEVICE) -> DenseWelfordState:
    device = config.get_device(device)
    batch = tuple(batch)
    return DenseWelfordState(
        count=torch.zeros(batch, dtype=dtype, device=device),
        mean=torch.zeros(batch + (dim,), dtype=dtype, device=device),
        m2=torch.zeros(batch + (dim, dim), dtype=dtype, device=device),
    )


def dense_welford_update(st: DenseWelfordState, x) -> DenseWelfordState:
    n = st.count + 1.0
    d = x - st.mean
    mean = st.mean + d / n[..., None]
    return DenseWelfordState(count=n, mean=mean, m2=st.m2 + _outer(d, x - mean))


def dense_welford_merge(a: DenseWelfordState, b: DenseWelfordState):
    """Pool two accumulators (cross-chain warmup pooling, Chan et al.)."""
    n = a.count + b.count
    safe = torch.clamp(n, min=1.0)
    d = b.mean - a.mean
    mean = a.mean + d * (b.count / safe)[..., None]
    m2 = a.m2 + b.m2 + _outer(d, d) * (a.count * b.count / safe)[..., None, None]
    return DenseWelfordState(count=n, mean=mean, m2=m2)


def dense_welford_cov(st: DenseWelfordState, regularize: bool = True):
    """Covariance estimate; Stan's dense shrinkage when ``regularize``:

        Sigma_reg = (n/(n+5)) * Sigma + 1e-3 * (5/(n+5)) * I

    keeps the metric SPD and conservative for short adaptation windows.
    """
    n = torch.clamp(st.count, min=2.0)[..., None, None]
    cov = st.m2 / (n - 1.0)
    if not regularize:
        return cov
    w = n / (n + 5.0)
    eye = torch.eye(st.mean.shape[-1], dtype=cov.dtype, device=cov.device)
    return w * cov + 1e-3 * (1.0 - w) * eye


def metric_from_cov(cov):
    """Cholesky factor L with ``Sigma = L L^T`` (lower), jitter-guarded."""
    dim = cov.shape[-1]
    trace = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
    scale = torch.clamp(trace / dim, min=1e-300)[..., None, None]
    eye = torch.eye(dim, dtype=cov.dtype, device=cov.device)
    return torch.linalg.cholesky(cov + 1e-12 * scale * eye)


def draw_momentum(xi, L):
    """``r ~ N(0, M)`` with ``M = Sigma^{-1}``: ``r = L^{-T} xi`` for
    standard normals ``xi`` (..., dim)."""
    return torch.linalg.solve_triangular(L.mT, xi[..., None], upper=True)[..., 0]


def velocity(L, r):
    """``M^{-1} r = Sigma r = L (L^T r)``: the leapfrog position update
    direction and the U-turn criterion's velocity."""
    return (L @ (L.mT @ r[..., None]))[..., 0]


def kinetic(L, r):
    """``0.5 r^T Sigma r = 0.5 ||L^T r||^2``."""
    y = (L.mT @ r[..., None])[..., 0]
    return 0.5 * torch.sum(y * y, dim=-1)
