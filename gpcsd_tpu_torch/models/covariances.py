"""Covariance components with the reference's param-dict API.

Counterpart of ``gpcsd_tpu.models.covariances`` (1D and 2D spatial SE,
temporal SE and Matern-1/2), mirroring the reference ``covariances.py``
(``GPCSD1DSpatialCovSE`` ``:29-96``, ``GPCSD2DSpatialCovSE`` ``:134-232``,
``GPCSDTemporalCovSE`` ``:240-271``, ``GPCSDTemporalCovMatern`` ``:274-305``).  Each param entry is
``{'value', 'prior', 'min', 'max'}`` as in the reference.  Initial values
are prior draws from an explicit ``numpy.random.Generator`` (a fresh
``default_rng(0)`` when none is given).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..ops import kernels as k_ops
from ..ops import spatial as sp_ops
from ..ops.quadrature import gauss_legendre, gauss_legendre_2d
from ..utils.grids import reduce_grid
from .priors import HalfNormal, InvGamma


def _gen(gen):
    return np.random.default_rng(0) if gen is None else gen


def _prior_draw(prior, gen):
    return float(prior.sample(gen))


def _flat(x):
    return np.asarray(x).reshape(-1)


def _on(a, device):
    """Flat float64 tensor of ``a`` on ``device`` (raises when the device
    is CUDA and there is no card)."""
    return k_ops._col(a).to(config.get_device(device))


def _interval_prior(lb, ub):
    """Default-prior helper: reference-heuristic InvGamma over [lb, ub].

    A degenerate interval (tiny grids) has its upper end widened so the
    default prior stays finite, as in the JAX package.
    """
    lb, ub = float(lb), float(ub)
    if not ub > lb:
        ub = 2.0 * abs(lb) if lb != 0 else 1.0
    return InvGamma.from_interval(lb, ub)


class GPCSD1DSpatialCov:
    """Geometry of a 1D spatial covariance: the electrode sites and the
    Gauss-Legendre rule over [a, b] (numpy, host-side)."""

    def __init__(self, x, a=None, b=None, ngl=100):
        self.x = np.asarray(x).reshape(-1, 1)
        xf = _flat(x)
        self.a = float(np.min(xf)) if a is None else float(a)
        self.b = float(np.max(xf)) if b is None else float(b)
        self.ngl = int(ngl)
        rule = gauss_legendre(self.a, self.b, self.ngl)
        self.gl_x = rule.x
        self.gl_w = rule.w


class GPCSD1DSpatialCovSE(GPCSD1DSpatialCov):
    """SE spatial covariance with the forward model folded in by quadrature."""

    kind = "se"

    def __init__(self, x, ell_prior=None, a=None, b=None, ngl=100, gen=None):
        super().__init__(x, a=a, b=b, ngl=ngl)
        xf = _flat(x)
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

    def compute_Ks(self, device=config.DEFAULT_DEVICE):
        """CSD-space spatial correlation at the electrode sites (nx, nx)."""
        x = _on(self.x, device)
        return k_ops.se(x, x, self.params["ell"]["value"])

    def compKphig_1d(self, z, R, device=config.DEFAULT_DEVICE):
        """LFP-CSD spatial cross covariance (nx, nz)."""
        return sp_ops.kphig_1d(
            _on(self.x, device), _on(z, device), _on(self.gl_x, device),
            _on(self.gl_w, device),
            self.params["ell"]["value"], R,
        )

    def compKphi_1d(self, R, xp=None, device=config.DEFAULT_DEVICE):
        """LFP-LFP spatial covariance (nx, nxp)."""
        return sp_ops.kphi_1d(
            _on(self.x, device), _on(self.gl_x, device), _on(self.gl_w, device),
            self.params["ell"]["value"], R, xp=None if xp is None else _on(xp, device),
        )


def _pts_on(a, device):
    """(n, 2) float64 tensor of the point list ``a`` on ``device``."""
    return k_ops._pts(a).to(config.get_device(device))


class GPCSD2DSpatialCov:
    """Geometry of a 2D spatial covariance: the electrode sites, the
    tensor-product Gauss-Legendre rule and the site-to-node distances
    (numpy, host-side)."""

    def __init__(self, x, a1, b1, a2, b2, ngl1, ngl2):
        self.x = np.asarray(x, dtype=np.float64)
        self.a1, self.b1, self.a2, self.b2 = a1, b1, a2, b2
        self.ngl1, self.ngl2 = int(ngl1), int(ngl2)
        rule = gauss_legendre_2d(a1, b1, a2, b2, self.ngl1, self.ngl2)
        self.gl_x_grid = rule.xy  # (ngl1*ngl2, 2)
        self.gl_w_prod = rule.w  # (ngl1*ngl2,)
        self._recompute_deltas()

    def _recompute_deltas(self):
        self.delta_w = sp_ops.pairwise_w(self.x, self.gl_x_grid).numpy()

    def reset_x(self, x_new):
        self.x = np.asarray(x_new, dtype=np.float64)
        self._recompute_deltas()


class GPCSD2DSpatialCovSE(GPCSD2DSpatialCov):
    """Product-SE spatial covariance with the 2D forward model folded in by
    quadrature."""

    kind = "se2d"

    def __init__(self, x, ell_prior1=None, ell_prior2=None, a1=None, b1=None,
                 a2=None, b2=None, ngl1=100, ngl2=100, gen=None):
        x = np.asarray(x, dtype=np.float64)
        a1 = float(np.min(x[:, 0])) if a1 is None else a1
        b1 = float(np.max(x[:, 0])) if b1 is None else b1
        a2 = float(np.min(x[:, 1])) if a2 is None else a2
        b2 = float(np.max(x[:, 1])) if b2 is None else b2
        super().__init__(x, a1, b1, a2, b2, ngl1, ngl2)
        gen = _gen(gen)
        x1, x2 = reduce_grid(x)
        if ell_prior1 is None:
            ell_prior1 = _interval_prior(
                2.0 * np.min(np.diff(x1)), 2.0 * (np.max(x1) - np.min(x1))
            )
        if ell_prior2 is None:
            ell_prior2 = _interval_prior(2.0 * np.min(np.diff(x2)), np.max(x2) - np.min(x2))
        # bound conventions follow the reference (``covariances.py:166-171``)
        self.params = {
            "ell1": {
                "value": _prior_draw(ell_prior1, gen),
                "prior": ell_prior1,
                "min": float(np.min(np.diff(x1))),
                "max": float(5.0 * np.max(x1) - np.min(x1)),
            },
            "ell2": {
                "value": _prior_draw(ell_prior2, gen),
                "prior": ell_prior2,
                "min": float(np.min(np.diff(x2))),
                "max": float(np.max(x2) - np.min(x2)),
            },
        }

    def _ells(self):
        return self.params["ell1"]["value"], self.params["ell2"]["value"]

    def geometry(self, device):
        """``(delta_w, gl_xy, gl_w)`` as tensors on ``device``."""
        device = config.get_device(device)
        return (
            torch.as_tensor(self.delta_w, dtype=config.DTYPE).to(device),
            _pts_on(self.gl_x_grid, device),
            _on(self.gl_w_prod, device),
        )

    def compute_Ks(self, device=config.DEFAULT_DEVICE):
        """CSD-space spatial correlation at the electrode sites (nx, nx)."""
        x = _pts_on(self.x, device)
        return k_ops.se_2d(x, x, *self._ells())

    def compKphig_2d(self, z, R, eps, device=config.DEFAULT_DEVICE):
        """LFP-CSD spatial cross covariance (nx, nz) for (nz, 2) sites z."""
        delta_w, gl_xy, gl_w = self.geometry(device)
        return sp_ops.kphig_2d(
            delta_w, gl_xy, _pts_on(z, device), gl_w, *self._ells(), R, eps
        )

    def compKphi_2d(self, R, eps, xp=None, device=config.DEFAULT_DEVICE):
        """LFP-LFP spatial covariance (nx, nxp)."""
        delta_w, gl_xy, gl_w = self.geometry(device)
        dwp = None if xp is None else sp_ops.pairwise_w(_pts_on(xp, device), gl_xy)
        return sp_ops.kphi_2d(delta_w, gl_xy, gl_w, *self._ells(), R, eps, delta_w_p=dwp)


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

    def compute_Kt(self, t=None, tprime=None, device=config.DEFAULT_DEVICE):
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
