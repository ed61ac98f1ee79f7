"""Random Fourier features for squared-exponential priors.

Counterpart of ``gpcsd_tpu.ops.rff``.  Pathwise (Matheron) posterior
sampling needs joint prior draws of the CSD field on (prediction points) u
(quadrature nodes).  The exact route Choleskys the (nz + ngl)^2 union
kernel; the Neuropixels 2D configuration has 3600 quadrature nodes and the
SE Gram there is numerically rank-deficient long before it is large.
Wilson et al. 2020 ("Efficiently sampling functions from GP posteriors")
replace the prior draw with a random Fourier feature expansion; the
posterior correction stays exact, so the only error is the O(1/sqrt(M))
approximation of the prior kernel:

    csd(x) ~= sqrt(2/M) * sum_m cos(w_m^T x + b_m) z_m,
    w_m ~ N(0, diag(1/ell^2)),  b_m ~ U(0, 2pi)   (SE spectral measure)

The random numbers are drawn apart from the features
(:func:`rff_draws`), so that a caller can pass in its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import DTYPE


def rff_draws(gen: np.random.Generator, d: int, n_features: int):
    """``(w_unit (d, M) standard normals, b (M,) uniforms on [0, 2 pi))``
    from ``gen``: every random number :func:`se_rff_features` consumes."""
    return gen.standard_normal((d, n_features)), gen.uniform(0.0, 2.0 * np.pi, n_features)


def se_rff_features(points, ells, w_unit, b):
    """Feature matrix Phi with Phi @ Phi^T ~= SE correlation kernel.

    :param points: (n,) / (n, 1) for 1D or (n, d) locations (a tensor; the
        features live on its device)
    :param ells: scalar length-scale or per-dimension (d,) length-scales
    :param w_unit: (d, M) standard normal draws (scaled by ``1/ells`` here)
    :param b: (M,) uniform draws on [0, 2 pi)
    :return: (n, M) feature matrix (unit prior variance)
    """
    pts = torch.as_tensor(points, dtype=DTYPE)
    if pts.ndim == 1:
        pts = pts[:, None]
    d = pts.shape[1]
    dev = pts.device
    ells = torch.as_tensor(ells, dtype=DTYPE, device=dev).reshape(-1).expand(d)
    w = torch.as_tensor(w_unit, dtype=DTYPE, device=dev) / ells[:, None]
    b = torch.as_tensor(b, dtype=DTYPE, device=dev)
    n_features = w.shape[1]
    return math.sqrt(2.0 / n_features) * torch.cos(pts @ w + b[None, :])
