"""Kronecker-structured Gaussian marginal likelihood and solves.

Counterpart of ``gpcsd_tpu.ops.kronlik`` (the float64 path only).  For
``K = Ks (x) Kt + diag(sig2n)`` with ``Ks = Qs Ls Qs^T`` and
``Kt = Qt Lt Qt^T``,

    K = (Qs (x) Qt) diag(D) (Qs (x) Qt)^T,   D = Ls (x) Lt + sig2n

so the log-likelihood needs two small ``eigh`` calls plus the per-trial
quadratic form ``sum (Qs^T Y_b Qt)^2 / D``, which
:func:`gpcsd_tpu_torch.ops.cuda.quadform.quadform` computes (a hand-written
kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda.quadform import quadform

_EIGH_GAP_EPS = 1e-12


class EighSafe(torch.autograd.Function):
    """Symmetric eigendecomposition with a gap-regularized derivative.

    ``torch.linalg.eigh``'s own backward divides by the raw eigenvalue gap,
    which is inf or NaN inside the clusters of near-equal tiny eigenvalues
    that Kt has at nt=600.  This backward is the VJP of the
    Lorentzian-regularized JVP of ``gpcsd_tpu.ops.kronlik.eigh_safe``: with
    ``g_ij = w_j - w_i`` and ``F_ij = g_ij / (g_ij^2 + eps^2)`` off the
    diagonal (``eps = 1e-12 * max(max|w|, 1)``),

        A_bar = sym(V (diag(w_bar) + F o (V^T V_bar)) V^T).

    It behaves like 1/gap for separated eigenvalues and goes to 0 inside
    degenerate clusters, where the likelihood is rotation-invariant.
    """

    @staticmethod
    def forward(ctx, a):
        w, v = torch.linalg.eigh(a)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, w_bar, v_bar):
        w, v = ctx.saved_tensors
        inner = torch.zeros_like(v)
        if v_bar is not None:
            gap = w[..., None, :] - w[..., :, None]  # gap[i, j] = w_j - w_i
            scale = torch.clamp(w.abs().amax(dim=-1, keepdim=True)[..., None], min=1.0)
            eps = _EIGH_GAP_EPS * scale
            f = gap / (gap * gap + eps * eps)
            f.diagonal(dim1=-2, dim2=-1).zero_()
            inner = f * (v.mT @ v_bar)
        if w_bar is not None:
            inner = inner + torch.diag_embed(w_bar)
        a_bar = v @ inner @ v.mT
        return 0.5 * (a_bar + a_bar.mT)


def eigh_safe(a):
    """``(eigenvalues, eigenvectors)`` like ``torch.linalg.eigh``, with the
    gap-regularized backward of :class:`EighSafe`."""
    return EighSafe.apply(a)


class KronFactors(NamedTuple):
    """Factorization of ``K = Ks (x) Kt + diag(noise)`` such that

        K^{-1} = (qs (x) qt) diag(1/d) (qs (x) qt)^T
        log|K| = sum(log d) + logdet_offset

    In the homoscedastic / reference-approximation path ``qs``/``qt`` are the
    orthogonal eigenvectors of Ks/Kt and ``logdet_offset`` is zero.  In the
    exact heteroscedastic path ``qs = S^{-1} Q~`` is the noise-whitened
    spatial basis (not orthogonal) and ``logdet_offset`` carries
    ``nt * sum(log sig2n)``.
    """

    qs: torch.Tensor  # (nx, nx)
    qt: torch.Tensor  # (nt, nt)
    lam_s: torch.Tensor  # (nx,)
    lam_t: torch.Tensor  # (nt,)
    d: torch.Tensor  # (nx, nt) diagonal in the (qs (x) qt) basis
    logdet_offset: torch.Tensor  # scalar


def _spatial_factors(Ks, sig2n, nt, het_exact):
    """Spatial eigenbasis + per-entry noise floor + logdet offset.

    ``het_exact=False`` reproduces the reference approximation for vector
    sig2n (D built in the eigenbasis of Ks alone, reference
    ``utility_functions.py:54-63``).  ``het_exact=True`` whitens by the
    noise first: with ``S = diag(sig2n)``,

        K = (S^{1/2} (x) I)(S^{-1/2} Ks S^{-1/2} (x) Kt + I)(S^{1/2} (x) I)

    so eigendecomposing the whitened Gram gives the exact diagonalization
    at the same cost.  For scalar sig2n both paths are the same.
    """
    het = het_exact and sig2n.ndim > 0
    eigh_in = Ks
    if het:
        s = torch.sqrt(sig2n)
        eigh_in = Ks / (s[:, None] * s[None, :])
    lam_s, qs = eigh_safe(eigh_in)
    # PSD + jitter: numerically negative eigenvalues (quadrature-Gram
    # roundoff) would push D below the noise floor and NaN the logdet
    lam_s = torch.clamp(lam_s, min=0.0)
    if het:
        qs = qs / s[:, None]
        noise = torch.ones((), dtype=Ks.dtype, device=Ks.device)
        logdet_offset = nt * torch.sum(torch.log(sig2n))
    else:
        noise = sig2n[..., None] if sig2n.ndim else sig2n
        logdet_offset = torch.zeros((), dtype=Ks.dtype, device=Ks.device)
    return qs, lam_s, noise, logdet_offset


def comp_eig_d(Ks, Kt, sig2n, het_exact: bool = False) -> KronFactors:
    """Joint factorization; ``sig2n`` is a scalar or per-channel (nx,) tensor.

    Matches reference ``comp_eig_D`` with D laid out (nx, nt): its flat
    ``Dvec = repeat(lam_s, nt) * tile(lam_t, nx) + sig2n`` is row-major
    (nx, nt).

    :param het_exact: with vector sig2n, use the exact noise-whitened
        factorization instead of the reference's approximation; no-op for
        scalar sig2n.
    """
    sig2n = torch.as_tensor(sig2n, dtype=Ks.dtype, device=Ks.device)
    lam_t, qt = eigh_safe(Kt)
    lam_t = torch.clamp(lam_t, min=0.0)
    qs, lam_s, noise, logdet_offset = _spatial_factors(
        Ks, sig2n, lam_t.shape[0], het_exact
    )
    d = lam_s[:, None] * lam_t[None, :] + noise
    return KronFactors(
        qs=qs, qt=qt, lam_s=lam_s, lam_t=lam_t, d=d, logdet_offset=logdet_offset
    )


def whiten(factors: KronFactors, Y):
    """``alpha = Qs^T Y Qt`` batched over leading axes; Y is (..., nx, nt)."""
    return factors.qs.mT @ Y @ factors.qt


def loglik(factors: KronFactors, Y):
    """Marginal log-likelihood of trials Y (..., nx, nt); sums trial axes.

    Drops the -0.5*n*log(2*pi) constant, matching reference ``loglik``
    (``gpcsd1d.py:113-128``).  The quadratic term goes through
    :func:`quadform`: the CUDA kernel on the card, its plain version on
    the CPU.
    """
    nx, nt = Y.shape[-2:]
    Yb = Y.reshape(-1, nx, nt)
    ntrials = Yb.shape[0]
    quad = quadform(
        factors.qs.contiguous(),
        factors.qt.contiguous(),
        (1.0 / factors.d).contiguous(),
        Yb.contiguous(),
    )
    logdet = ntrials * (torch.sum(torch.log(factors.d)) + factors.logdet_offset)
    return -0.5 * (logdet + quad)


def kron_solve(factors: KronFactors, Y):
    """``(Ks (x) Kt + diag(sig2n))^{-1} Y`` per trial, fully factored.

    Y is (..., nx, nt); returns the same shape.  Replaces the reference's
    dense ``mykron(Qs, Qt) @ diag(1/D) @ ...`` (``gpcsd1d.py:262-265``).
    """
    alpha = whiten(factors, Y) / factors.d
    return factors.qs @ alpha @ factors.qt.mT


def mykron(A, B):
    """Dense Kronecker product (kept for tests/interop; avoid in hot paths)."""
    a1, a2 = A.shape
    b1, b2 = B.shape
    return torch.reshape(A[:, None, :, None] * B[None, :, None, :], (a1 * b1, a2 * b2))
