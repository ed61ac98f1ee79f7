"""Stationary covariance kernels (plain functions on tensors).

Counterpart of ``gpcsd_tpu.ops.kernels``.  Parity targets: the SE spatial
and temporal kernels and the Matern-1/2 temporal kernel of the reference
``covariances.py`` (``compute_Ks`` ``:50-56``/``:177-186``, ``GPCSDTemporalCovSE.compute_Kt``
``:257-271``, ``GPCSDTemporalCovMatern.compute_Kt`` ``:291-305``).

Coordinates may be numpy arrays (placed on the CPU) or tensors (kept on
their device); parameters are floats or tensors.  A parameter tensor of
shape ``(C,)`` (one value per chain or stencil point) gives a batch of
``C`` matrices, ``(C, nx, ny)``.
"""

from __future__ import annotations

import torch

from ..config import DTYPE


def _col(x):
    return torch.as_tensor(x, dtype=DTYPE).reshape(-1)


def _mat(p):
    """A parameter shaped to broadcast against (nx, ny) matrices: floats
    and 0-d tensors as they are, ``(C,)`` tensors as ``(C, 1, 1)``."""
    return p[..., None, None] if isinstance(p, torch.Tensor) and p.ndim else p


def se(x, y, ell):
    """Squared-exponential correlation exp(-0.5 (x-y)^2 / ell^2); (nx, ny)."""
    d = _col(x)[:, None] - _col(y)[None, :]
    return torch.exp(-0.5 * torch.square(d / _mat(ell)))


def _pts(xy):
    return torch.as_tensor(xy, dtype=DTYPE).reshape(-1, 2)


def sq_diffs_2d(xy, zw):
    """Squared coordinate differences between (n, 2) and (m, 2) point
    lists, one (n, m) tensor per dimension.  They do not depend on the
    parameters: a caller that evaluates :func:`se_2d_from_sq` many times on
    one geometry computes them once."""
    xy, zw = _pts(xy), _pts(zw)
    return (
        torch.square(xy[:, 0][:, None] - zw[:, 0][None, :]),
        torch.square(xy[:, 1][:, None] - zw[:, 1][None, :]),
    )


def se_2d_from_sq(sq1, sq2, ell1, ell2):
    """Product-SE correlation from the squared differences of
    :func:`sq_diffs_2d`: ``exp(-0.5 sq1/ell1^2 - 0.5 sq2/ell2^2)``."""
    ell1, ell2 = _mat(ell1), _mat(ell2)
    return torch.exp(sq1 * (-0.5 / (ell1 * ell1)) + sq2 * (-0.5 / (ell2 * ell2)))


def se_2d(xy, zw, ell1, ell2):
    """Product-SE correlation over 2D points; (n, m), or (C, n, m) for
    ``(C,)`` lengthscales.  ``xy`` (n, 2) and ``zw`` (m, 2) are point lists."""
    return se_2d_from_sq(*sq_diffs_2d(xy, zw), ell1, ell2)


def temporal_se(t, tprime, ell, sigma2):
    """SE temporal covariance sigma2 * exp(-0.5 dt^2/ell^2); (nt, ntp)."""
    return _mat(sigma2) * se(t, tprime, ell)


def temporal_matern12(t, tprime, ell, sigma2):
    """Matern-1/2 (exponential) covariance sigma2 * exp(-|dt|/ell)."""
    d = _col(t)[:, None] - _col(tprime)[None, :]
    return _mat(sigma2) * torch.exp(-torch.abs(d) / _mat(ell))


#: registry used by the model layer to assemble temporal covariance stacks
TEMPORAL_KERNELS = {
    "se": temporal_se,
    "matern": temporal_matern12,
}
