"""CSD -> LFP forward operator (1D), counterpart of ``gpcsd_tpu.ops.forward``.

Physics parity targets: the weight ``b(r, R) = sqrt((r/R)^2 + 1) - |r/R|``
(reference ``forward_models.py:9-17``) and its trapezoid-rule data-space
forward model (``forward_models.py:20-39``), applied as one dense (nz, nx)
operator over all time points.
"""

from __future__ import annotations

import torch

from .kernels import _col


def b_fwd_1d(r, R):
    """1D forward-model weight function; elementwise in ``r``."""
    u = r / R
    return torch.sqrt(torch.square(u) + 1.0) - torch.abs(u)


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
