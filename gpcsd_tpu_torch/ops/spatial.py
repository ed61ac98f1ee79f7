"""Quadrature spatial covariances (1D), counterpart of ``gpcsd_tpu.ops.spatial``.

The GPCSD trick (reference ``covariances.py``): apply the CSD->LFP integral
operator analytically to the spatial kernel through a fixed Gauss-Legendre
rule.  With ``A = gl_w * b(x - gl_x, R)``,

    Kphi(x, xp)  = A(x) @ K(gl, gl) @ A(xp)^T      (compKphi_1d, :74-96)
    Kphig(x, z)  = A(x) @ K(gl, z)                  (compKphig_1d, :58-72)
"""

from __future__ import annotations

from .forward import b_fwd_1d
from .kernels import _col, se


def quad_weights_1d(x, gl_x, gl_w, R):
    """A(x) = gl_w * b(x - gl_x, R); shape (nx, ngl)."""
    delta = _col(x)[:, None] - _col(gl_x)[None, :]
    return _col(gl_w)[None, :] * b_fwd_1d(delta, R)


def kphi_1d(x, gl_x, gl_w, ell, R, xp=None):
    """LFP-LFP spatial covariance (nx, nxp); forward model on both sides."""
    A = quad_weights_1d(x, gl_x, gl_w, R)
    Ap = A if xp is None else quad_weights_1d(xp, gl_x, gl_w, R)
    return A @ se(gl_x, gl_x, ell) @ Ap.T


def kphig_1d(x, z, gl_x, gl_w, ell, R):
    """LFP-CSD spatial cross-covariance (nx, nz); forward model on x only."""
    return quad_weights_1d(x, gl_x, gl_w, R) @ se(gl_x, z, ell)
