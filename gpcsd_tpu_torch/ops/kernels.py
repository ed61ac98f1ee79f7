"""Stationary covariance kernels (plain functions on tensors).

Counterpart of ``gpcsd_tpu.ops.kernels``.  Parity targets: the SE spatial
and temporal kernels and the Matern-1/2 temporal kernel of the reference
``covariances.py`` (``compute_Ks`` ``:50-56``, ``GPCSDTemporalCovSE.compute_Kt``
``:257-271``, ``GPCSDTemporalCovMatern.compute_Kt`` ``:291-305``).

Coordinates may be numpy arrays (placed on the CPU) or tensors (kept on
their device); parameters are floats or 0-d tensors.
"""

from __future__ import annotations

import torch

from ..config import DTYPE


def _col(x):
    return torch.as_tensor(x, dtype=DTYPE).reshape(-1)


def se(x, y, ell):
    """Squared-exponential correlation exp(-0.5 (x-y)^2 / ell^2); (nx, ny)."""
    d = _col(x)[:, None] - _col(y)[None, :]
    return torch.exp(-0.5 * torch.square(d / ell))


def temporal_se(t, tprime, ell, sigma2):
    """SE temporal covariance sigma2 * exp(-0.5 dt^2/ell^2); (nt, ntp)."""
    return sigma2 * se(t, tprime, ell)


def temporal_matern12(t, tprime, ell, sigma2):
    """Matern-1/2 (exponential) covariance sigma2 * exp(-|dt|/ell)."""
    d = _col(t)[:, None] - _col(tprime)[None, :]
    return sigma2 * torch.exp(-torch.abs(d) / ell)


#: registry used by the model layer to assemble temporal covariance stacks
TEMPORAL_KERNELS = {
    "se": temporal_se,
    "matern": temporal_matern12,
}
