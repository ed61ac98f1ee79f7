"""CSD -> LFP forward operators (1D and 2D), counterpart of
``gpcsd_tpu.ops.forward``.

Physics parity targets: the 1D weight ``b(r, R) = sqrt((r/R)^2 + 1) - |r/R|``
(reference ``forward_models.py:9-17``), the 2D weight
``b(w, R, eps) = log(R+eps+sqrt((R+eps)^2+w^2)) - log(eps+sqrt(eps^2+w^2))``
(``forward_models.py:42-54``) and their trapezoid-rule data-space forward
models (``forward_models.py:20-39`` and ``:57-81``), each applied as one
dense operator over all time points.
"""

from __future__ import annotations

import torch

from .kernels import _col


def b_fwd_1d(r, R):
    """1D forward-model weight function; elementwise in ``r``."""
    u = r / R
    return torch.sqrt(torch.square(u) + 1.0) - torch.abs(u)


def b_fwd_2d(w, R, eps):
    """2D forward-model weight as a function of planar distance ``w``."""
    Re = R + eps
    return torch.log(Re + torch.sqrt(Re * Re + w * w)) - torch.log(
        eps + torch.sqrt(eps * eps + w * w)
    )


def trapezoid_weights(x):
    """Composite trapezoid-rule weights for (possibly nonuniform) nodes x."""
    x = _col(x)
    d = torch.diff(x)
    w = torch.zeros_like(x)
    w[:-1] += 0.5 * d
    w[1:] += 0.5 * d
    return w


def fwd_operator_1d(x, z, R, varsigma=1.0):
    """Dense (nz, nx) linear operator mapping CSD at nodes x to LFP at z.

    Rows are ``R/(2*varsigma) * trapz_w * b((z_i - x_j)/R)``, matching the
    per-element integral of the reference ``fwd_model_1d``.
    """
    x = _col(x)
    z = _col(z)
    W = b_fwd_1d(z[:, None] - x[None, :], R) * trapezoid_weights(x)[None, :]
    return (R / (2.0 * varsigma)) * W


def fwd_model_1d(arr, x, z, R, varsigma=1.0):
    """Apply the 1D forward model to a CSD array.

    :param arr: (..., nx, nt) CSD sampled at locations ``x``
    :return: (..., nz, nt) LFP at locations ``z``
    """
    op = fwd_operator_1d(x, z, R, varsigma)
    return op @ torch.as_tensor(arr, dtype=op.dtype)


def fwd_operator_2d(x1, x2, z, R, eps):
    """Dense (nz, nx1, nx2) operator for the 2D forward model.

    ``z`` is an (nz, 2) list of output locations; the CSD lives on the tensor
    grid x1 (x) x2.  Matches the double-trapezoid integral of the reference
    ``fwd_model_2d``, whose ``1/(4*pi*varsigma)`` gain is left out there
    (``forward_models.py:81``) and therefore here.
    """
    x1, x2 = _col(x1), _col(x2)
    z = torch.as_tensor(z, dtype=x1.dtype).reshape(-1, 2)
    d1 = z[:, 0][:, None] - x1[None, :]  # (nz, nx1)
    d2 = z[:, 1][:, None] - x2[None, :]  # (nz, nx2)
    w = torch.sqrt(torch.square(d1)[:, :, None] + torch.square(d2)[:, None, :])
    tw = trapezoid_weights(x1)[None, :, None] * trapezoid_weights(x2)[None, None, :]
    return b_fwd_2d(w, R, eps) * tw


def fwd_model_2d(arr, x1, x2, z, R, eps, varsigma=1.0):
    """Apply the 2D forward model.

    :param arr: (..., nx1, nx2, nt) CSD on the grid
    :return: (..., nz, nt) LFP at the (nz, 2) locations ``z``
    """
    del varsigma  # the reference leaves the 1/(4*pi*varsigma) gain out
    op = fwd_operator_2d(x1, x2, z, R, eps)
    return torch.einsum("zjk,...jkt->...zt", op, torch.as_tensor(arr, dtype=op.dtype))
