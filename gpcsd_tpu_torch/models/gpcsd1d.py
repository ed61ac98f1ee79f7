"""GPCSD1D: 1D Gaussian-process current source density model.

Counterpart of ``gpcsd_tpu.models.gpcsd1d`` (constructor, parameter
round-trip, ``loglik`` and the scipy MAP ``fit``), with the reference's API
(``gpcsd1d.py``: constructor defaults ``:21-62``, ``loglik`` ``:113-128``,
``fit`` ``:130-246``, param round-trip ``:84-102``).  The numerics are the
functional core in :mod:`gpcsd_tpu_torch.models.core`, on the model's
``device``.

Data layout: the constructor takes the reference's ``(nx, nt, ntrials)`` LFP
array; :meth:`GPCSD1D._Y` gives the ``(ntrials, nx, nt)`` trial tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..infer.map import map_fit, sample_restarts
from ..ops.spatial import kphi_1d
from .core import ModelFns, make_model_fns
from .covariances import (
    GPCSD1DSpatialCovSE,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
    _interval_prior,
    _prior_draw,
)
from .params import ParamSet, ParamSpec
from .priors import HalfNormal

JITTER = config.JITTER_1D


class GPCSD1D:
    def __init__(
        self,
        lfp,
        x,
        t,
        a=None,
        b=None,
        ngl=100,
        spatial_cov=None,
        temporal_cov_list=None,
        R_prior=None,
        sig2n_prior=None,
        het_noise="approx",
        device="cpu",
        gen=None,
    ):
        """
        :param lfp: LFP array, shape (n_spatial, n_time, n_trials)
        :param x: observed spatial locations (n_spatial, 1), microns
        :param t: observed time points (n_time, 1), milliseconds
        :param a, b: integration bounds (default min/max of x)
        :param ngl: Gauss-Legendre order (default 100)
        :param spatial_cov: GPCSD1DSpatialCovSE instance (default built here)
        :param temporal_cov_list: list of temporal covariance objects
            (default [SE, Matern], matching the reference)
        :param R_prior: prior for R (default InvGamma from electrode geometry)
        :param sig2n_prior: prior for noise variance: a single prior for
            scalar noise or a list for per-channel noise
        :param het_noise: per-channel-noise likelihood mode: "approx"
            reproduces the reference's eigenbasis approximation
            (``utility_functions.py:54-63``), "exact" uses the
            noise-whitened exact factorization at the same cost.  Ignored
            for scalar noise (both are exact there).
        :param device: where the likelihood runs; "cuda" raises when there
            is no card.
        :param gen: ``numpy.random.Generator`` for the initial prior draws
            of every default parameter (``default_rng(0)`` when None).
        """
        if het_noise not in ("approx", "exact"):
            raise ValueError(f"het_noise must be 'approx' or 'exact', got {het_noise!r}")
        self.het_noise = het_noise
        self.device = config.get_device(device)
        gen = np.random.default_rng(0) if gen is None else gen
        lfp = np.asarray(lfp, dtype=np.float64)
        if lfp.ndim == 2:
            lfp = lfp[:, :, None]
        self.lfp = lfp
        self.x = np.asarray(x, dtype=np.float64).reshape(-1, 1)
        self.t = np.asarray(t, dtype=np.float64).reshape(-1, 1)
        xf = self.x.reshape(-1)
        self.a = float(np.min(xf)) if a is None else float(a)
        self.b = float(np.max(xf)) if b is None else float(b)
        self.ngl = int(ngl)
        if spatial_cov is None:
            spatial_cov = GPCSD1DSpatialCovSE(
                self.x, a=self.a, b=self.b, ngl=self.ngl, gen=gen
            )
        self.spatial_cov = spatial_cov
        if temporal_cov_list is None:
            temporal_cov_list = [
                GPCSDTemporalCovSE(self.t, gen=gen),
                GPCSDTemporalCovMatern(self.t, gen=gen),
            ]
        self.temporal_cov_list = temporal_cov_list
        if R_prior is None:
            R_prior = _interval_prior(
                float(np.min(np.diff(xf))), 0.5 * float(np.max(xf) - np.min(xf))
            )
        self.R = {
            "value": _prior_draw(R_prior, gen),
            "prior": R_prior,
            "min": 0.5 * float(np.min(np.diff(xf))),
            "max": 0.8 * float(np.max(xf) - np.min(xf)),
        }
        if sig2n_prior is None:
            sig2n_prior = HalfNormal(0.1)
        if isinstance(sig2n_prior, list):
            self.sig2n = {
                "value": np.array([_prior_draw(sp, gen) for sp in sig2n_prior]),
                "prior": sig2n_prior,
                "min": [1e-8] * len(sig2n_prior),
                "max": [0.5] * len(sig2n_prior),
            }
        else:
            self.sig2n = {
                "value": _prior_draw(sig2n_prior, gen),
                "prior": sig2n_prior,
                "min": 1e-8,
                "max": 0.5,
            }
        self._fns_cache = {}

    # ------------------------------------------------------------------ API

    def extract_model_params(self):
        """Reference-schema param dict (pickle-compatible, ``gpcsd1d.py:84-91``)."""
        return {
            "R": self.R["value"],
            "sig2n": self.sig2n["value"],
            "spatial_ell": self.spatial_cov.params["ell"]["value"],
            "temporal_ell_list": [tc.params["ell"]["value"] for tc in self.temporal_cov_list],
            "temporal_sigma2_list": [
                tc.params["sigma2"]["value"] for tc in self.temporal_cov_list
            ],
        }

    def restore_model_params(self, params):
        if len(self.temporal_cov_list) != len(params["temporal_ell_list"]):
            raise ValueError("different number of temporal covariance functions!")
        self.R["value"] = params["R"]
        self.sig2n["value"] = params["sig2n"]
        self.spatial_cov.params["ell"]["value"] = params["spatial_ell"]
        for i, tc in enumerate(self.temporal_cov_list):
            tc.params["ell"]["value"] = params["temporal_ell_list"][i]
            tc.params["sigma2"]["value"] = params["temporal_sigma2_list"][i]

    # ------------------------------------------------------- functional core

    @property
    def _sig2n_is_vector(self):
        return np.asarray(self.sig2n["value"]).ndim > 0

    def _tensor(self, v):
        return torch.tensor(np.asarray(v, dtype=np.float64), device=self.device)

    def _theta(self):
        """Current constrained parameter values as a flat-named dict of
        tensors on the model's device."""
        theta = {
            "R": self._tensor(self.R["value"]),
            "ell": self._tensor(self.spatial_cov.params["ell"]["value"]),
        }
        for i, tc in enumerate(self.temporal_cov_list):
            theta[f"tm{i}_ell"] = self._tensor(tc.params["ell"]["value"])
            theta[f"tm{i}_sigma2"] = self._tensor(tc.params["sigma2"]["value"])
        theta["sig2n"] = self._tensor(self.sig2n["value"])
        return theta

    def _set_theta(self, theta):
        self.R["value"] = float(theta["R"])
        self.spatial_cov.params["ell"]["value"] = float(theta["ell"])
        for i, tc in enumerate(self.temporal_cov_list):
            tc.params["ell"]["value"] = float(theta[f"tm{i}_ell"])
            tc.params["sigma2"]["value"] = float(theta[f"tm{i}_sigma2"])
        s = np.asarray(theta["sig2n"].detach().cpu())
        self.sig2n["value"] = s if s.ndim else float(s)

    def _param_set(self, fix_R=False) -> ParamSet:
        """Parameter order matches the reference tparams vector
        (``gpcsd1d.py:137-151``): R, spatial ell, per-temporal (ell, sigma2),
        sig2n; R and spatial ell carry the /100 scaling convention."""
        specs = {}
        if not fix_R:
            specs["R"] = ParamSpec(
                prior=self.R["prior"], lo=self.R["min"], hi=self.R["max"], scale=100.0
            )
        sp = self.spatial_cov.params["ell"]
        specs["ell"] = ParamSpec(prior=sp["prior"], lo=sp["min"], hi=sp["max"], scale=100.0)
        for i, tc in enumerate(self.temporal_cov_list):
            pe, ps2 = tc.params["ell"], tc.params["sigma2"]
            specs[f"tm{i}_ell"] = ParamSpec(prior=pe["prior"], lo=pe["min"], hi=pe["max"])
            specs[f"tm{i}_sigma2"] = ParamSpec(
                prior=ps2["prior"], lo=max(ps2["min"], 1e-300), hi=ps2["max"]
            )
        if self._sig2n_is_vector:
            specs["sig2n"] = ParamSpec(
                prior=tuple(self.sig2n["prior"]),
                lo=np.asarray(self.sig2n["min"]),
                hi=np.asarray(self.sig2n["max"]),
                size=int(np.asarray(self.sig2n["value"]).size),
            )
        else:
            specs["sig2n"] = ParamSpec(
                prior=self.sig2n["prior"], lo=self.sig2n["min"], hi=self.sig2n["max"]
            )
        return ParamSet(specs)

    def _fns(self, fix_R=False) -> ModelFns:
        key = (fix_R, self.het_noise, self.lfp.shape, self.t.shape[0],
               float(self.t[0, 0]), float(self.t[-1, 0]))
        if key in self._fns_cache:
            return self._fns_cache[key]
        sc = self.spatial_cov
        x = self._tensor(self.x.reshape(-1))
        gl_x = self._tensor(sc.gl_x)
        gl_w = self._tensor(sc.gl_w)
        jitter_eye = JITTER * torch.eye(x.shape[0], dtype=config.DTYPE, device=self.device)

        def build_ks(theta):
            return kphi_1d(x, gl_x, gl_w, theta["ell"], theta["R"]) + jitter_eye

        fixed = {}
        fixed_lp = 0.0
        if fix_R:
            fixed["R"] = self._tensor(self.R["value"])
            fixed_lp = float(self.R["prior"].lpdf(self.R["value"]))
        fns = make_model_fns(
            self._param_set(fix_R=fix_R),
            build_ks,
            tuple(tc.kind for tc in self.temporal_cov_list),
            self._tensor(self.t.reshape(-1)),
            fixed=fixed,
            fixed_log_prior=fixed_lp,
            het_exact=self.het_noise == "exact",
        )
        self._fns_cache[key] = fns
        return fns

    def _Y(self):
        """(ntrials, nx, nt) contiguous trial tensor on the model's device."""
        return self._tensor(np.ascontiguousarray(np.moveaxis(self.lfp, 2, 0)))

    # ------------------------------------------------------------- inference

    def loglik(self):
        """Marginal log likelihood at the current parameter values."""
        with torch.no_grad():
            return float(self._fns().loglik(self._theta(), self._Y()))

    def fit(
        self,
        n_restarts=10,
        method="L-BFGS-B",
        fix_R=False,
        verbose=False,
        backend="scipy",
        seed=0,
        options=None,
    ):
        """Multi-restart MAP fit; writes the best parameters back in place.

        Restart draws come from ``numpy.random.default_rng(seed)``.
        :param backend: 'scipy' (serial L-BFGS-B, the reference-parity path)
            is the only backend of this package so far.
        """
        del method  # only L-BFGS-B is supported, as in the reference
        if backend != "scipy":
            raise ValueError(f"unknown backend {backend!r}: this package has 'scipy' only")
        options = options or {}
        fns = self._fns(fix_R=fix_R)
        res = map_fit(
            fns.neg_log_joint,
            fns.param_set,
            self._Y(),
            sample_restarts(fns.param_set, np.random.default_rng(seed), n_restarts),
            maxiter=options.get("maxiter", 1000),
            gtol=options.get("gtol", 1e-5),
            ftol=options.get("ftol", 1e7 * np.finfo(float).eps),
            verbose=verbose,
        )
        theta = fns.param_set.unpack(torch.as_tensor(res.u_best))
        if fix_R:
            theta["R"] = self._tensor(self.R["value"])
        self._set_theta(theta)
        self.fit_result = res
        return res
