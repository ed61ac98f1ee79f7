"""Covariance components with the reference's param-dict API.

Counterpart of ``gpcsd_tpu.models.covariances`` (1D spatial SE, temporal SE
and Matern-1/2), mirroring the reference ``covariances.py``
(``GPCSD1DSpatialCovSE`` ``:29-96``, ``GPCSDTemporalCovSE`` ``:240-271``,
``GPCSDTemporalCovMatern`` ``:274-305``).  Each param entry is
``{'value', 'prior', 'min', 'max'}`` as in the reference.  Initial values
are prior draws from an explicit ``numpy.random.Generator`` (a fresh
``default_rng(0)`` when none is given).
"""

from __future__ import annotations

import numpy as np

from ..ops import kernels as k_ops
from ..ops import spatial as sp_ops
from ..ops.quadrature import gauss_legendre
from .priors import HalfNormal, InvGamma


def _gen(gen):
    return np.random.default_rng(0) if gen is None else gen


def _prior_draw(prior, gen):
    return float(prior.sample(gen))


def _flat(x):
    return np.asarray(x).reshape(-1)


def _on(a, device):
    """Flat float64 tensor of ``a`` on ``device``."""
    return k_ops._col(a).to(device)


def _interval_prior(lb, ub):
    """Default-prior helper: reference-heuristic InvGamma over [lb, ub].

    A degenerate interval (tiny grids) has its upper end widened so the
    default prior stays finite, as in the JAX package.
    """
    lb, ub = float(lb), float(ub)
    if not ub > lb:
        ub = 2.0 * abs(lb) if lb != 0 else 1.0
    return InvGamma.from_interval(lb, ub)


class GPCSD1DSpatialCovSE:
    """SE spatial covariance with the forward model folded in by quadrature."""

    kind = "se"

    def __init__(self, x, ell_prior=None, a=None, b=None, ngl=100, gen=None):
        self.x = np.asarray(x).reshape(-1, 1)
        xf = _flat(x)
        self.a = float(np.min(xf)) if a is None else float(a)
        self.b = float(np.max(xf)) if b is None else float(b)
        self.ngl = int(ngl)
        rule = gauss_legendre(self.a, self.b, self.ngl)
        self.gl_x = rule.x
        self.gl_w = rule.w
        if ell_prior is None:
            ell_prior = _interval_prior(
                1.2 * np.min(np.diff(xf)), 0.8 * (np.max(xf) - np.min(xf))
            )
        self.params = {
            "ell": {
                "value": _prior_draw(ell_prior, _gen(gen)),
                "prior": ell_prior,
                "min": float(0.5 * np.min(np.diff(xf))),
                "max": float(np.max(xf) - np.min(xf)),
            }
        }

    def compute_Ks(self, device="cpu"):
        """CSD-space spatial correlation at the electrode sites (nx, nx)."""
        x = _on(self.x, device)
        return k_ops.se(x, x, self.params["ell"]["value"])

    def compKphig_1d(self, z, R, device="cpu"):
        """LFP-CSD spatial cross covariance (nx, nz)."""
        return sp_ops.kphig_1d(
            _on(self.x, device), _on(z, device), _on(self.gl_x, device),
            _on(self.gl_w, device),
            self.params["ell"]["value"], R,
        )

    def compKphi_1d(self, R, xp=None, device="cpu"):
        """LFP-LFP spatial covariance (nx, nxp)."""
        return sp_ops.kphi_1d(
            _on(self.x, device), _on(self.gl_x, device), _on(self.gl_w, device),
            self.params["ell"]["value"], R, xp=None if xp is None else _on(xp, device),
        )


class GPCSDTemporalCov:
    kind: str

    def __init__(self, t, ell_prior, sigma2_prior, sigma2_min, gen):
        self.t = np.asarray(t).reshape(-1, 1)
        tf = _flat(self.t)
        gen = _gen(gen)
        if ell_prior is None:
            ell_prior = _interval_prior(
                1.2 * np.min(np.diff(tf)), 0.8 * (np.max(tf) - np.min(tf))
            )
        if sigma2_prior is None:
            sigma2_prior = HalfNormal(1.0)
        self.params = {
            "ell": {
                "value": _prior_draw(ell_prior, gen),
                "prior": ell_prior,
                "min": float(0.5 * np.min(np.diff(tf))),
                "max": float(np.max(tf) - np.min(tf)),
            },
            "sigma2": {
                "value": _prior_draw(sigma2_prior, gen),
                "prior": sigma2_prior,
                "min": sigma2_min,
                "max": np.inf,
            },
        }

    def compute_Kt(self, t=None, tprime=None, device="cpu"):
        t = _on(self.t if t is None else t, device)
        tprime = _on(self.t if tprime is None else tprime, device)
        return k_ops.TEMPORAL_KERNELS[self.kind](
            t, tprime, self.params["ell"]["value"], self.params["sigma2"]["value"]
        )


class GPCSDTemporalCovSE(GPCSDTemporalCov):
    kind = "se"

    def __init__(self, t, ell_prior=None, sigma2_prior=None, gen=None):
        super().__init__(t, ell_prior, sigma2_prior, sigma2_min=1e-8, gen=gen)


class GPCSDTemporalCovMatern(GPCSDTemporalCov):
    kind = "matern"

    def __init__(self, t, ell_prior=None, sigma2_prior=None, gen=None):
        super().__init__(t, ell_prior, sigma2_prior, sigma2_min=0.0, gen=gen)
