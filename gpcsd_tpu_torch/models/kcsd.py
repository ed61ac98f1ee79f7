"""kCSD: kernel current source density (1D), counterpart of
``gpcsd_tpu.models.kcsd``.

The reference compares GPCSD against the external ``kcsd`` package
(``simulation_studies/simple_template_1D.py:99-107``,
``sim_from_gp_1D.py:112-127``, ``auditory_lfp/fit_mean_function.py:113-115``:
KCSD1D with ``cross_validate(Rs, lambdas)`` and ``values()``).  This module
provides that comparison method (Potworowski et al. 2012):

- CSD modeled as a sum of M Gaussian basis sources of width R;
- each basis source is pushed through the same cylinder forward model used
  by GPCSD (the port's ``ops/forward.fwd_operator_1d``, evaluated in
  float64 on the CPU) to get LFP basis functions;
- ridge (Tikhonov) solution in the induced kernel space with
  leave-one-out cross-validation over (R, lambda) via the hat-matrix
  shortcut: no refitting per electrode.

Matrices are tiny (n_elec <= 128): numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.forward import fwd_operator_1d


class KCSD1D:
    def __init__(self, ele_pos, pots, gdx=10.0, h=None, R_init=100.0,
                 lambd=1e-5, n_src=300, ext=0.0):
        """
        :param ele_pos: (n, 1) electrode positions (microns)
        :param pots: (n, nt) measured potentials
        :param gdx: estimation grid spacing
        :param h: cylinder radius of the forward model (reference passes
            ``h=R_true``)
        :param n_src: number of Gaussian basis sources
        :param ext: extension of the source span beyond the electrode span
        """
        self.ele_pos = np.asarray(ele_pos, dtype=np.float64).reshape(-1)
        self.pots = np.atleast_2d(np.asarray(pots, dtype=np.float64))
        if self.pots.shape[0] != self.ele_pos.size:
            self.pots = self.pots.T
        self.h = float(h) if h is not None else 100.0
        self.R = float(R_init)
        self.lambd = float(lambd)
        lo, hi = self.ele_pos.min() - ext, self.ele_pos.max() + ext
        self.src_x = np.linspace(lo, hi, int(n_src))
        ngrid = int(np.rint((hi - lo) / gdx)) + 1
        self.estm_x = np.linspace(lo, hi, ngrid)

    # -- kernel machinery ----------------------------------------------------

    def _phi_basis(self, R):
        """(n_src, n_ele) LFP response of each unit Gaussian source."""
        # dense quadrature grid for the forward integral of each source
        quad_x = np.linspace(self.src_x.min() - 3 * R, self.src_x.max() + 3 * R, 800)
        basis = np.exp(
            -0.5 * (quad_x[None, :] - self.src_x[:, None]) ** 2 / (R / 2.0) ** 2
        )  # (n_src, nq); width R/2 as in kcsd's gauss basis
        op = fwd_operator_1d(torch.as_tensor(quad_x), torch.as_tensor(self.ele_pos),
                             self.h).numpy()  # (n_ele, nq)
        return basis @ op.T  # (n_src, n_ele)

    def _csd_basis(self, R):
        """(n_src, n_est) CSD value of each source on the estimation grid."""
        return np.exp(
            -0.5 * (self.estm_x[None, :] - self.src_x[:, None]) ** 2 / (R / 2.0) ** 2
        )

    def _kernels(self, R):
        phi = self._phi_basis(R)  # (m, n)
        K = phi.T @ phi / phi.shape[0]  # (n, n)
        csd = self._csd_basis(R)
        K_cross = csd.T @ phi / phi.shape[0]  # (n_est, n)
        return K, K_cross

    # -- API ------------------------------------------------------------------

    def values(self, estimate="CSD"):
        """Estimated CSD (n_est, nt) at the current (R, lambd)."""
        K, K_cross = self._kernels(self.R)
        n = K.shape[0]
        sol = np.linalg.solve(K + self.lambd * np.eye(n), self.pots)
        return K_cross @ sol

    def cross_validate(self, Rs=None, lambdas=None):
        """Leave-one-out CV over (R, lambda); sets self.R/self.lambd.

        LOO residuals via the smoother-matrix shortcut:
        e_i = ((I - S) V)_i / (1 - S_ii), S = K (K + lambda I)^{-1}.
        """
        Rs = np.atleast_1d(Rs if Rs is not None else np.linspace(50, 500, 10))
        lambdas = np.atleast_1d(
            lambdas if lambdas is not None else np.logspace(-8, 0, 20)
        )
        n = self.ele_pos.size
        best = (np.inf, self.R, self.lambd)
        for R in Rs:
            K, _ = self._kernels(float(R))
            for lam in lambdas:
                S = K @ np.linalg.inv(K + float(lam) * np.eye(n))
                resid = self.pots - S @ self.pots
                denom = np.clip(1.0 - np.diag(S), 1e-10, None)[:, None]
                loo = resid / denom
                err = float(np.mean(loo**2))
                if err < best[0]:
                    best = (err, float(R), float(lam))
        _, self.R, self.lambd = best
        self.cv_error = best[0]
        return self.R, self.lambd
