"""Plain reference of the GPCSD log-joint: value and gradient.

Written from the model's equations (Klein et al. 2021; the reference code's
``gpcsd1d.py``/``gpcsd2d.py``, ``covariances.py``, ``priors.py``), in plain
PyTorch, in any float dtype, on any device.  It imports nothing of the
program under test.

The LFP of one trial, ``vec(Y_b)`` with the channel index major, is Gaussian
with covariance ``K = Ks (x) Kt + diag(s) (x) I``: ``Ks`` the LFP spatial
covariance (the CSD kernel pushed through the forward model by
Gauss-Legendre quadrature, plus a diagonal jitter), ``Kt`` the sum of the
temporal kernels, ``s`` the per-channel noise variances (a scalar noise is
the same value on every channel).  With ``S = diag(s)``,
``S^{-1/2} Ks S^{-1/2} = Qw diag(ls) Qw^T`` and ``Kt = Qt diag(lt) Qt^T``,

    K^{-1} = (P (x) Qt) diag(1/D) (P (x) Qt)^T,   P = S^{-1/2} Qw,
    D = ls lt^T + 1,   log|K| = nt sum(log s) + sum(log D).

Eigenvalues are projected onto >= 0 (both matrices are covariances).  The
gradient is not taken through the eigendecompositions: the derivative of
the log-likelihood with respect to ``K`` is ``-(T K^{-1} - sum_b a_b a_b^T)/2``
with ``a_b = K^{-1} vec(Y_b)``, which the trace identities above turn into
``dL/dKs``, ``dL/dKt`` and ``dL/ds`` (:meth:`Problem.likelihood`); autograd
then carries them through the smooth covariance builders, the priors and the
transform.  The constant ``-n log(2 pi) / 2`` is left out, as the model does.

Parameters are unconstrained ``u`` with ``theta = scale * exp(u)``, packed in
the configuration's order; priors are the unnormalized inverse-gamma
``-(a+1) log x - b/x`` and half-normal ``-(x/sd)^2/2``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import roots_legendre


def gauss_legendre(a, b, n):
    """Nodes and weights of the n-point Gauss-Legendre rule on [a, b]."""
    x, w = roots_legendre(n)
    half = 0.5 * (b - a)
    return half * (x + 1.0) + a, half * w


def expand_grid(x1, x2):
    """All pairs (a, b), a in x1 (outer), b in x2 (inner): (len1*len2, 2)."""
    return np.stack([np.repeat(x1, x2.size), np.tile(x2, x1.size)], axis=1)


def se(x, y, ell):
    """exp(-(x - y)^2 / (2 ell^2)) over all pairs."""
    d = x[:, None] - y[None, :]
    return torch.exp(-0.5 * torch.square(d / ell))


def matern12(x, y, ell):
    """exp(-|x - y| / ell) over all pairs."""
    d = x[:, None] - y[None, :]
    return torch.exp(-torch.abs(d) / ell)


def temporal_cov(kinds, theta, t):
    """Sum of the temporal components ``sigma2_i k_i(t, t; ell_i)``."""
    comps = []
    for i, kind in enumerate(kinds):
        ell, sigma2 = theta[f"tm{i}_ell"], theta[f"tm{i}_sigma2"]
        comps.append(sigma2 * (se(t, t, ell) if kind == "se" else matern12(t, t, ell)))
    return sum(comps)


def b_1d(r, R):
    """1D forward-model weight sqrt((r/R)^2 + 1) - |r/R|."""
    u = r / R
    return torch.sqrt(torch.square(u) + 1.0) - torch.abs(u)


def b_2d(w, R, eps):
    """2D forward-model weight at planar distance w."""
    Re = R + eps
    return torch.log(Re + torch.sqrt(Re * Re + w * w)) - torch.log(eps + torch.sqrt(eps * eps + w * w))


class Spatial1D:
    """LFP spatial covariance of a linear probe: ``A Kgl A^T + jitter I`` with
    ``A_ij = w_j b(x_i - g_j, R)`` over the Gauss-Legendre nodes ``g``."""

    def __init__(self, x, gl_x, gl_w, jitter, dtype, device):
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype=dtype, device=device)  # noqa: E731
        self.x, self.gl_x, self.gl_w = as_t(x), as_t(gl_x), as_t(gl_w)
        self.jitter_eye = jitter * torch.eye(self.x.numel(), dtype=dtype, device=device)

    def __call__(self, theta):
        A = self.gl_w[None, :] * b_1d(self.x[:, None] - self.gl_x[None, :], theta["R"])
        return A @ se(self.gl_x, self.gl_x, theta["ell"]) @ A.mT + self.jitter_eye


class Spatial2D:
    """LFP spatial covariance of a planar probe over a tensor-product rule:
    ``A Kgl A^T + jitter I`` with ``A_ij = w_j b2(|x_i - g_j|, R, eps)`` and
    the product-SE ``Kgl`` over the nodes."""

    def __init__(self, x, gl_xy, gl_w, eps, jitter, dtype, device):
        as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype=dtype, device=device)  # noqa: E731
        x, g = as_t(x), as_t(gl_xy)
        self.gl_w, self.eps = as_t(gl_w), eps
        d1 = x[:, 0][:, None] - g[:, 0][None, :]
        d2 = x[:, 1][:, None] - g[:, 1][None, :]
        self.delta_w = torch.sqrt(torch.square(d1) + torch.square(d2))
        self.sq1 = torch.square(g[:, 0][:, None] - g[:, 0][None, :])
        self.sq2 = torch.square(g[:, 1][:, None] - g[:, 1][None, :])
        self.jitter_eye = jitter * torch.eye(x.shape[0], dtype=dtype, device=device)

    def __call__(self, theta):
        ell1, ell2 = theta["ell1"], theta["ell2"]
        A = self.gl_w[None, :] * b_2d(self.delta_w, theta["R"], self.eps)
        Kgl = torch.exp(self.sq1 * (-0.5 / (ell1 * ell1)) + self.sq2 * (-0.5 / (ell2 * ell2)))
        return A @ Kgl @ A.mT + self.jitter_eye


def prior_lpdf(prior, x):
    if prior["kind"] == "invgamma":
        return -(prior["alpha"] + 1.0) * torch.log(x) - prior["beta"] / x
    if prior["kind"] == "halfnormal":
        return -0.5 * torch.square(x / prior["sd"])
    raise ValueError(f"unknown prior {prior['kind']!r}")


class Problem:
    """The log-joint of one configuration on one data set.

    :param params: the configuration's ``params`` list (name, size, scale,
        prior, lo, hi), in packing order
    :param spatial: ``theta -> Ks`` (:class:`Spatial1D`, :class:`Spatial2D`)
    :param kinds: temporal component kinds, ``"se"`` or ``"matern"``
    :param t: (nt,) times, ms; :param Y: (ntrials, nx, nt) LFP
    """

    def __init__(self, params, spatial, kinds, t, Y, dtype, device):
        self.params, self.spatial, self.kinds = params, spatial, tuple(kinds)
        self.dtype, self.device = dtype, torch.device(device)
        self.t = torch.as_tensor(np.asarray(t, dtype=np.float64)).to(dtype=dtype, device=self.device)
        self.Y = torch.as_tensor(np.asarray(Y, dtype=np.float64)).to(dtype=dtype, device=self.device)
        self.dim = sum(p["size"] for p in params)
        self.log_scale = sum(p["size"] * math.log(p["scale"]) for p in params)

    def pack(self, theta) -> np.ndarray:
        """Constrained values (name -> float or array) -> u."""
        return np.concatenate([
            np.log(np.broadcast_to(np.asarray(theta[p["name"]], dtype=np.float64), (p["size"],))
                   / p["scale"]) for p in self.params])

    def bounds(self):
        """Box of the MAP fit in u: (lo, hi), each (dim,)."""
        lo, hi = [], []
        for p in self.params:
            lo += [math.log(p["lo"] / p["scale"])] * p["size"]
            hi += [math.inf if p["hi"] is None else math.log(p["hi"] / p["scale"])] * p["size"]
        return np.array(lo), np.array(hi)

    def unpack(self, u):
        theta, off = {}, 0
        for p in self.params:
            v = torch.exp(u[off:off + p["size"]]) * p["scale"]
            theta[p["name"]] = v[0] if p["size"] == 1 else v
            off += p["size"]
        return theta

    def log_prior(self, theta):
        total = 0.0
        for p in self.params:
            total = total + prior_lpdf(p["prior"], theta[p["name"]]).sum()
        return total

    def likelihood(self, Ks, Kt, s, grads=True):
        """``(L, dL/dKs, dL/dKt, dL/ds)`` at the covariances, without autograd
        (``L`` alone when not ``grads``)."""
        T, nx, nt = self.Y.shape
        sq = torch.sqrt(s)
        ls, Qw = torch.linalg.eigh(Ks / (sq[:, None] * sq[None, :]))
        lt, Qt = torch.linalg.eigh(Kt)
        ls, lt = torch.clamp(ls, min=0.0), torch.clamp(lt, min=0.0)
        P = Qw / sq[:, None]
        D = ls[:, None] * lt[None, :] + 1.0
        W = P.mT @ self.Y @ Qt
        L = -0.5 * (T * (nt * torch.sum(torch.log(s)) + torch.sum(torch.log(D)))
                    + torch.sum(torch.square(W) / D))
        if not grads:
            return L
        a = P @ (W / D) @ Qt.mT  # K^{-1} vec(Y_b), as (T, nx, nt)
        aKt = (a @ Kt).transpose(0, 1).reshape(nx, T * nt)
        G_s = 0.5 * (aKt @ a.transpose(0, 1).reshape(nx, T * nt).mT
                     - T * (P * (lt[None, :] / D).sum(1)[None, :]) @ P.mT)
        Ksa = (Ks @ a).reshape(T * nx, nt)
        G_t = 0.5 * (a.reshape(T * nx, nt).mT @ Ksa
                     - T * (Qt * (ls[:, None] / D).sum(0)[None, :]) @ Qt.mT)
        g_s = 0.5 * (torch.square(a).sum(dim=(0, 2)) - T * (torch.square(P) @ (1.0 / D).sum(1)))
        return L, G_s, G_t, g_s

    def value_and_grad(self, u, jacobian=True):
        """The log-joint at u and its gradient, as float and (dim,) numpy.

        :param jacobian: add the transform's log-Jacobian (the posterior
            density NUTS samples); without it, the MAP objective's negative
        """
        u = torch.as_tensor(np.asarray(u, dtype=np.float64)).to(dtype=self.dtype, device=self.device)
        u.requires_grad_(True)
        theta = self.unpack(u)
        Ks = self.spatial(theta)
        Kt = temporal_cov(self.kinds, theta, self.t)
        s = theta["sig2n"] * torch.ones(Ks.shape[0], dtype=self.dtype, device=self.device)
        with torch.no_grad():
            L, G_s, G_t, g_s = self.likelihood(Ks, Kt, s)
        extra = self.log_prior(theta)
        if jacobian:
            extra = extra + torch.sum(u) + self.log_scale
        surrogate = (Ks * G_s).sum() + (Kt * G_t).sum() + (s * g_s).sum() + extra
        (g,) = torch.autograd.grad(surrogate, u)
        return float(L + extra.detach()), g.cpu().numpy().astype(np.float64)

    def value(self, u, jacobian=True):
        """The log-joint at u, as :meth:`value_and_grad` without the gradient."""
        u = torch.as_tensor(np.asarray(u, dtype=np.float64)).to(dtype=self.dtype, device=self.device)
        with torch.no_grad():
            theta = self.unpack(u)
            Ks = self.spatial(theta)
            s = theta["sig2n"] * torch.ones(Ks.shape[0], dtype=self.dtype, device=self.device)
            v = self.likelihood(Ks, temporal_cov(self.kinds, theta, self.t), s, grads=False)
            v = v + self.log_prior(theta)
            if jacobian:
                v = v + torch.sum(u) + self.log_scale
        return float(v)

    def log_prob(self, u):
        """Posterior density in u and its gradient."""
        return self.value_and_grad(u, jacobian=True)

    def nll(self, u):
        """The MAP objective (negative log-likelihood plus prior) and its gradient."""
        v, g = self.value_and_grad(u, jacobian=False)
        return -v, -g
