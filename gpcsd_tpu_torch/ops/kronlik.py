"""Kronecker-structured Gaussian marginal likelihood and solves.

Counterpart of ``gpcsd_tpu.ops.kronlik`` (the float64 path only).  For
``K = Ks (x) Kt + diag(sig2n)`` with ``Ks = Qs Ls Qs^T`` and
``Kt = Qt Lt Qt^T``,

    K = (Qs (x) Qt) diag(D) (Qs (x) Qt)^T,   D = Ls (x) Lt + sig2n

so the log-likelihood needs two small ``eigh`` calls plus the per-trial
quadratic form ``sum (Qs^T Y_b Qt)^2 / D``, which
:func:`gpcsd_tpu_torch.ops.cuda.quadform.quadform` computes (a hand-written
kernel on the card, its plain version on the CPU).  The temporal ``eigh``
goes through :func:`temporal_eigh`: on the card the batched block-Jacobi
kernel of :mod:`gpcsd_tpu_torch.ops.cuda.eigh`, on the CPU (and for small
n, or a single large matrix) ``torch.linalg.eigh``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import count, span
from .cuda import eigh as _eigh_cuda
from .cuda.quadform import quadform

_EIGH_GAP_EPS = 1e-12

#: The smallest order of ``Kt`` that the card factors by the block-Jacobi
#: kernel; smaller ones go to ``torch.linalg.eigh`` (cuSOLVER).  From
#: ``chip_smoke.py``'s phase ``eigh_jacobi`` on an H100 at 700 W: at four
#: rows (the chains of a NUTS pass, a small fit's restarts) the kernel is 2-6x
#: faster at every n from 30 to 375 (at 60: 0.37 against 2.91 ms), at one row
#: it is faster at n = 60 and 100 (0.37 against 0.73 ms, 0.91 against 1.32) and
#: within 30% either way elsewhere.  Below 60 the models are the tests' toys.
JACOBI_MIN_N = 60
#: The largest order at which a single matrix (a pass of one row) goes to the
#: kernel; a larger one goes to ``torch.linalg.eigh``.  One matrix runs on one
#: cluster of at most 16 CTAs, and its ~185 rounds at n = 600 are a chain.
#: From ``chip_smoke.py``'s phase ``eigh_jacobi`` on an H100 at 700 W, one
#: row, kernel against library: 2.72 against 2.81 ms at n = 300, 4.12 against
#: 3.43 at 375, 9.81 against 6.29 at 600.  End to end at n = 600 through the
#: kernel, a one-restart auditory fit took 2.37-2.39 s against 1.86-1.94 s
#: through cuSOLVER, and a one-chain sampler drew 7.6-7.9 against 10.4-11.3
#: draws/s.
JACOBI_MAX_N_ALONE = 300


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

    Leading axes are a batch (one ``torch.linalg.eigh`` call).  In a batch,
    a matrix with a non-finite entry gives NaN eigenvalues, as
    ``jnp.linalg.eigh`` does, where ``torch.linalg.eigh`` would raise for
    the whole batch: a sampler's divergent trajectory reaches such points
    and must see a non-finite density in that row only.  A single matrix
    goes to ``torch.linalg.eigh`` as it is.

    On the card ``torch.linalg.eigh`` reads its error flag back to the host,
    a sync per call (counter ``host_sync.kronlik.eigh``).  The backward runs
    on autograd's device thread inside span ``gpcsd.kronlik.eigh_backward``;
    :class:`EighJacobi` shares it.
    """

    @staticmethod
    def forward(ctx, a):
        count("host_sync.kronlik.eigh")
        if a.ndim == 2:
            w, v = torch.linalg.eigh(a)
        else:
            w, v = _finite_rows(torch.linalg.eigh, a)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, w_bar, v_bar):
        with span("gpcsd.kronlik.eigh_backward"):
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


def _finite_rows(eigh, a):
    """``eigh`` of a batch with each matrix that holds a non-finite entry
    replaced by I, and NaN eigenvalues for it."""
    finite = torch.isfinite(a).all(dim=-1).all(dim=-1)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    w, v = eigh(torch.where(finite[..., None, None], a, eye))
    return torch.where(finite[..., None], w, torch.nan), v


class EighJacobi(EighSafe):
    """:class:`EighSafe`'s regularized backward around the card's batched
    block-Jacobi eigensolver (:func:`gpcsd_tpu_torch.ops.cuda.eigh.eigh_jacobi_cuda`):
    one launch for every matrix of the batch, no host sync.  A matrix with a
    non-finite entry gives NaN eigenvalues, whether in a batch or alone."""

    @staticmethod
    def forward(ctx, a):
        batch = a.shape[:-2]
        flat = a.reshape(-1, *a.shape[-2:]).contiguous()
        w, v = _finite_rows(_eigh_cuda.eigh_jacobi_cuda, flat)
        w, v = w.reshape(*batch, -1), v.reshape(a.shape)
        ctx.save_for_backward(w, v)
        return w, v


def eigh_safe(a):
    """``(eigenvalues, eigenvectors)`` like ``torch.linalg.eigh``, with the
    gap-regularized backward of :class:`EighSafe`."""
    return EighSafe.apply(a)


def temporal_eigh(kt):
    """The temporal factor's ``(eigenvalues, eigenvectors)``, with the
    regularized backward of :class:`EighSafe`: the one dispatch point for
    ``Kt``.  A CUDA ``Kt`` of order :data:`JACOBI_MIN_N` or more goes to the
    batched block-Jacobi kernel (:class:`EighJacobi`: every row in one
    launch, no host sync) when it holds two matrices or more, or one of
    order :data:`JACOBI_MAX_N_ALONE` or less; a CPU one, a smaller one or a
    single larger one to ``torch.linalg.eigh`` as :func:`eigh_safe` calls
    it."""
    n = kt.shape[-1]
    if kt.is_cuda and n >= JACOBI_MIN_N and (kt.numel() > n * n or n <= JACOBI_MAX_N_ALONE):
        return EighJacobi.apply(kt)
    return EighSafe.apply(kt)


class KronFactors(NamedTuple):
    """Factorization of ``K = Ks (x) Kt + diag(noise)`` such that

        K^{-1} = (qs (x) qt) diag(1/d) (qs (x) qt)^T
        log|K| = sum(log d) + logdet_offset

    In the homoscedastic / reference-approximation path ``qs``/``qt`` are the
    orthogonal eigenvectors of Ks/Kt and ``logdet_offset`` is zero.  In the
    exact heteroscedastic path ``qs = S^{-1} Q~`` is the noise-whitened
    spatial basis (not orthogonal) and ``logdet_offset`` carries
    ``nt * sum(log sig2n)``.

    Every field may carry one leading batch axis ``C`` (a factorization
    per chain or stencil point).
    """

    qs: torch.Tensor  # (nx, nx)
    qt: torch.Tensor  # (nt, nt)
    lam_s: torch.Tensor  # (nx,)
    lam_t: torch.Tensor  # (nt,)
    d: torch.Tensor  # (nx, nt) diagonal in the (qs (x) qt) basis
    logdet_offset: torch.Tensor  # scalar


def _whitened(sig2n, batch_ndim, het_exact):
    """Whether the exact heteroscedastic path applies: ``het_exact`` and a
    per-channel ``sig2n``, one axis more than the ``batch_ndim`` batch axes."""
    return het_exact and sig2n.ndim > batch_ndim


def spatial_eigh_input(Ks, sig2n, het_exact: bool = False):
    """The first half of :func:`comp_eig_d`: the matrix the spatial ``eigh``
    factors.

    ``het_exact=False`` gives ``Ks`` itself: with vector sig2n that is the
    reference approximation (D built in the eigenbasis of Ks alone,
    reference ``utility_functions.py:54-63``).  ``het_exact=True`` whitens
    by the noise first: with ``S = diag(sig2n)``,

        K = (S^{1/2} (x) I)(S^{-1/2} Ks S^{-1/2} (x) Kt + I)(S^{1/2} (x) I)

    so eigendecomposing the whitened Gram gives the exact diagonalization
    at the same cost.  For scalar sig2n both paths are the same.

    ``Ks`` may be a batch ``(C, nx, nx)``; ``sig2n`` is then ``(C,)`` or
    ``(C, nx)``, and is per-channel when it has one axis more than the
    batch.  The temporal ``eigh`` takes ``Kt`` as it is.
    """
    if _whitened(sig2n, Ks.ndim - 2, het_exact):
        s = torch.sqrt(sig2n)
        return Ks / (s[..., :, None] * s[..., None, :])
    return Ks


def factors_from_eigenpairs(lam_t, qt, lam_s, qs, sig2n, het_exact: bool = False) -> KronFactors:
    """The second half of :func:`comp_eig_d`: the factors from the two
    ``eigh`` results, ``(lam_t, qt)`` of ``Kt`` and ``(lam_s, qs)`` of
    :func:`spatial_eigh_input`, with the same batch axes.

    The eigenvalues are clamped at 0: PSD + jitter, numerically negative
    eigenvalues (quadrature-Gram roundoff) would push D below the noise
    floor and NaN the logdet.  On the whitened path ``qs`` is mapped back
    by ``S^{-1/2}`` and ``logdet_offset`` carries ``nt * sum(log sig2n)``;
    otherwise ``noise`` is shaped to broadcast against ``(nx, nt)``.  Only
    the whitened path reads ``qs``, and neither reads ``qt``: either may be
    None where the caller does not need it back.
    """
    lam_t = torch.clamp(lam_t, min=0.0)
    lam_s = torch.clamp(lam_s, min=0.0)
    batch = lam_s.shape[:-1]
    if _whitened(sig2n, len(batch), het_exact):
        qs = qs / torch.sqrt(sig2n)[..., :, None]
        noise = torch.ones((), dtype=lam_s.dtype, device=lam_s.device)
        logdet_offset = lam_t.shape[-1] * torch.sum(torch.log(sig2n), dim=-1)
    else:
        noise = sig2n[..., None] if sig2n.ndim > len(batch) else sig2n[..., None, None]
        logdet_offset = torch.zeros(batch, dtype=lam_s.dtype, device=lam_s.device)
    d = lam_s[..., :, None] * lam_t[..., None, :] + noise
    return KronFactors(
        qs=qs, qt=qt, lam_s=lam_s, lam_t=lam_t, d=d, logdet_offset=logdet_offset
    )


def comp_eig_d(Ks, Kt, sig2n, het_exact: bool = False) -> KronFactors:
    """Joint factorization; ``sig2n`` is a scalar or per-channel (nx,) tensor.
    ``Ks``, ``Kt`` and ``sig2n`` may all carry one leading batch axis.

    Matches reference ``comp_eig_D`` with D laid out (nx, nt): its flat
    ``Dvec = repeat(lam_s, nt) * tile(lam_t, nx) + sig2n`` is row-major
    (nx, nt).  The composition of :func:`spatial_eigh_input`,
    :func:`temporal_eigh` of ``Kt``, :func:`eigh_safe` of the spatial
    matrix and :func:`factors_from_eigenpairs`.

    :param het_exact: with vector sig2n, use the exact noise-whitened
        factorization instead of the reference's approximation; no-op for
        scalar sig2n.
    """
    with span("gpcsd.kronlik.comp_eig_d"):
        sig2n = torch.as_tensor(sig2n, dtype=Ks.dtype, device=Ks.device)
        eigh_in = spatial_eigh_input(Ks, sig2n, het_exact)
        lam_t, qt = temporal_eigh(Kt)
        lam_s, qs = eigh_safe(eigh_in)
        return factors_from_eigenpairs(lam_t, qt, lam_s, qs, sig2n, het_exact)


def whiten(factors: KronFactors, Y):
    """``alpha = Qs^T Y Qt`` batched over leading axes; Y is (..., nx, nt)."""
    return factors.qs.mT @ Y @ factors.qt


def quad_term(factors: KronFactors, Y):
    """``sum_b vec(Y_b)^T K^{-1} vec(Y_b)`` over the trials Y (..., nx, nt),
    through :func:`quadform`: the CUDA kernel on the card, its plain
    version on the CPU.  Batched factors ``(C, ...)`` give ``(C,)`` values
    of the same trials, with one :func:`quadform` call (one kernel launch)
    per row: the kernel takes one ``(qs, qt, dinv)``, and here each row has
    its own (``quadform_rows`` batches trials that share them)."""
    nx, nt = Y.shape[-2:]
    Yb = Y.reshape(-1, nx, nt).contiguous()
    with span("gpcsd.kronlik.quad_term"):
        dinv = 1.0 / factors.d
        if dinv.ndim == 2:
            return quadform(factors.qs.contiguous(), factors.qt.contiguous(), dinv.contiguous(), Yb)
        return torch.stack([
            quadform(qs.contiguous(), qt.contiguous(), di.contiguous(), Yb)
            for qs, qt, di in zip(factors.qs, factors.qt, dinv)
        ])


def loglik(factors: KronFactors, Y, ntrials=None):
    """Marginal log-likelihood of trials Y (..., nx, nt); sums trial axes.

    Drops the -0.5*n*log(2*pi) constant, matching reference ``loglik``
    (``gpcsd1d.py:113-128``).  The quadratic term is :func:`quad_term`;
    batched factors ``(C, ...)`` give ``(C,)`` values.

    :param ntrials: the trial count of the log-determinant term, when ``Y``
        is one block of a larger set of trials (default: ``Y``'s own)
    """
    if ntrials is None:
        ntrials = Y[..., 0, 0].numel()
    return -0.5 * (logdet_term(factors, ntrials) + quad_term(factors, Y))


def logdet_term(factors: KronFactors, ntrials):
    """``ntrials * log|K|``, the log-determinant term of :func:`loglik`;
    batched factors ``(C, ...)`` give ``(C,)``."""
    return ntrials * (torch.sum(torch.log(factors.d), dim=(-2, -1)) + factors.logdet_offset)


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


def kron_cross_mean(Kxz, Ktt, V):
    """Posterior mean contraction ``(Kxz (x) Ktt)^T vec(V)`` per trial, as
    two float64 matmuls.

    :param Kxz: (nx, nz) spatial cross-covariance (data side first)
    :param Ktt: (nt, ntstar) temporal cross-covariance (data side first)
    :param V: (..., nx, nt) solve output from :func:`kron_solve`
    :return: (..., nz, ntstar)
    """
    return Kxz.mT @ V @ Ktt
