"""Quadrature spatial covariances, counterpart of ``gpcsd_tpu.ops.spatial``.

The GPCSD trick (reference ``covariances.py``): apply the CSD->LFP integral
operator analytically to the spatial kernel through a fixed Gauss-Legendre
rule.  With ``A = gl_w * b(x - gl_x, R)``,

    Kphi(x, xp)  = A(x) @ K(gl, gl) @ A(xp)^T      (compKphi_1d, :74-96)
    Kphig(x, z)  = A(x) @ K(gl, z)                  (compKphig_1d, :58-72)

and their 2D analogues on a tensor-product rule (compKphi_2d ``:204-232``,
compKphig_2d ``:188-202``).  The quadrature rule and the pairwise distances
are static geometry, passed in as tensors; the model layer computes them
once.
"""

from __future__ import annotations

import torch

from ..config import DTYPE
from .forward import b_fwd_1d, b_fwd_2d
from .kernels import _col, _mat, _pts, se, se_2d, se_2d_from_sq


def quad_weights_1d(x, gl_x, gl_w, R):
    """A(x) = gl_w * b(x - gl_x, R); shape (nx, ngl), or (C, nx, ngl) for
    a ``(C,)`` tensor R."""
    delta = _col(x)[:, None] - _col(gl_x)[None, :]
    return _col(gl_w)[None, :] * b_fwd_1d(delta, _mat(R))


def kphi_1d(x, gl_x, gl_w, ell, R, xp=None):
    """LFP-LFP spatial covariance (nx, nxp); forward model on both sides."""
    A = quad_weights_1d(x, gl_x, gl_w, R)
    Ap = A if xp is None else quad_weights_1d(xp, gl_x, gl_w, R)
    return A @ se(gl_x, gl_x, ell) @ Ap.mT


def kphig_1d(x, z, gl_x, gl_w, ell, R):
    """LFP-CSD spatial cross-covariance (nx, nz); forward model on x only."""
    return quad_weights_1d(x, gl_x, gl_w, R) @ se(gl_x, z, ell)


def quad_weights_2d(delta_w, gl_w, R, eps):
    """A = gl_w * b(w, R, eps) from precomputed planar distances; (nx, ngl),
    or (C, nx, ngl) for a ``(C,)`` tensor R.

    :param delta_w: (nx, ngl) distances ||x_i - gl_j|| (static geometry)
    :param gl_w: (ngl,) product quadrature weights
    """
    delta_w = torch.as_tensor(delta_w, dtype=DTYPE)
    return _col(gl_w)[None, :] * b_fwd_2d(delta_w, _mat(R), eps)


def pairwise_w(x, y):
    """Planar distances between (n, 2) and (m, 2) point lists; (n, m)."""
    x, y = _pts(x), _pts(y)
    d1 = x[:, 0][:, None] - y[:, 0][None, :]
    d2 = x[:, 1][:, None] - y[:, 1][None, :]
    return torch.sqrt(torch.square(d1) + torch.square(d2))


def kphi_2d(delta_w, gl_xy, gl_w, ell1, ell2, R, eps, delta_w_p=None, gl_sq=None):
    """2D LFP-LFP spatial covariance (nx, nxp).

    :param delta_w: (nx, ngl) distances from LFP sites to quadrature nodes
    :param gl_xy: (ngl, 2) quadrature node grid
    :param delta_w_p: optional (nxp, ngl) distances for the second side
    :param gl_sq: optional ``sq_diffs_2d(gl_xy, gl_xy)``, computed once by a
        caller that evaluates this at many parameter values: two
        (ngl, ngl) tensors that every evaluation would otherwise rebuild
    """
    A = quad_weights_2d(delta_w, gl_w, R, eps)
    Ap = A if delta_w_p is None else quad_weights_2d(delta_w_p, gl_w, R, eps)
    if gl_sq is None:
        Kgl = se_2d(gl_xy, gl_xy, ell1, ell2)
    else:
        Kgl = se_2d_from_sq(*gl_sq, ell1, ell2)
    return A @ Kgl @ Ap.mT


def kphig_2d(delta_w, gl_xy, z, gl_w, ell1, ell2, R, eps):
    """2D LFP-CSD cross-covariance (nx, nz) for CSD locations z (nz, 2)."""
    return quad_weights_2d(delta_w, gl_w, R, eps) @ se_2d(gl_xy, z, ell1, ell2)
