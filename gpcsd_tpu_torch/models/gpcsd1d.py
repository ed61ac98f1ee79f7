"""GPCSD1D: 1D Gaussian-process current source density model.

Counterpart of ``gpcsd_tpu.models.gpcsd1d`` (constructor, parameter
round-trip, ``loglik``, the MAP ``fit``, ``predict``, ``predict_variance``,
``predict_samples``, ``sample_prior`` and, through
:class:`InferenceAPIMixin`, ``sample_posterior``), with the reference's
API (``gpcsd1d.py``: constructor defaults ``:21-62``, ``loglik``
``:113-128``, ``fit`` ``:130-246``, param round-trip ``:84-102``, ``predict``
``:248-293``, ``sample_prior`` ``:295-309``).  The numerics are the
functional core in :mod:`gpcsd_tpu_torch.models.core`, on the model's
``device``: the card unless the caller asks for the CPU.

Data layout: the constructor takes the reference's ``(nx, nt, ntrials)`` LFP
array; :meth:`GPCSD1D._Y` gives the ``(ntrials, nx, nt)`` trial tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..infer.map import map_fit, sample_restarts
from ..ops.kernels import se
from ..ops.spatial import kphi_1d, quad_weights_1d
from ..utils.profiling import traced_call
from .core import (
    ModelFns,
    make_model_fns,
    posterior_predict,
    posterior_variance,
    predict_samples,
)
from .covariances import (
    GPCSD1DSpatialCovSE,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
    _interval_prior,
    _prior_draw,
)
from .inference_api import InferenceAPIMixin
from .params import ParamSet, ParamSpec
from .priors import HalfNormal

JITTER = config.JITTER_1D


class GPCSD1D(InferenceAPIMixin):
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
        device=config.DEFAULT_DEVICE,
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
        :param device: where the model runs: the card unless the caller
            asks for ``"cpu"``; raises when CUDA is asked for and absent.
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

    def __str__(self):
        s = "GPCSD1D object\n"
        s += "LFP shape: (%d, %d, %d)\n" % self.lfp.shape
        s += "Integration bounds: (%d, %d)\n" % (self.a, self.b)
        s += "Integration number points: %d\n" % self.ngl
        s += "R parameter prior: %s\n" % str(self.R["prior"])
        s += "R parameter value %0.4g\n" % self.R["value"]
        s += "Spatial covariance ell prior: %s\n" % str(self.spatial_cov.params["ell"]["prior"])
        s += "Spatial covariance ell value %0.4g\n" % self.spatial_cov.params["ell"]["value"]
        for i, tc in enumerate(self.temporal_cov_list):
            s += "Temporal covariance %d class name: %s\n" % (i + 1, type(tc).__name__)
            s += "Temporal covariance %d ell prior: %s\n" % (i + 1, str(tc.params["ell"]["prior"]))
            s += "Temporal covariance %d ell value %0.4g\n" % (i + 1, tc.params["ell"]["value"])
            s += "Temporal covariance %d sigma2 prior: %s\n" % (i + 1, str(tc.params["sigma2"]["prior"]))
            s += "Temporal covariance %d sigma2 value %0.4g\n" % (i + 1, tc.params["sigma2"]["value"])
        return s

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

    def update_lfp(self, new_lfp, t, x=None):
        """Replace the data (and its time points, and optionally the
        electrode positions), keeping the parameter values."""
        if x is not None:
            self.x = np.asarray(x, dtype=np.float64).reshape(-1, 1)
            self.spatial_cov.x = self.x
        self.t = np.asarray(t, dtype=np.float64).reshape(-1, 1)
        for tc in self.temporal_cov_list:
            tc.t = self.t
        lfp = np.asarray(new_lfp, dtype=np.float64)
        if lfp.ndim == 2:
            lfp = lfp[:, :, None]
        self.lfp = lfp
        self._fns_cache = {}

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

    @traced_call("gpcsd.fit")
    def fit(
        self,
        n_restarts=10,
        method="L-BFGS-B",
        fix_R=False,
        verbose=False,
        backend="torch",
        seed=0,
        options=None,
    ):
        """Multi-restart MAP fit; writes the best parameters back in place.

        Restart draws come from ``numpy.random.default_rng(seed)``.
        :param backend: 'torch' (all restarts in one batched L-BFGS run on
            the model's device) or 'scipy' (serial L-BFGS-B, the
            reference-parity path).
        :param options: ``maxiter`` (1000), ``gtol``, ``ftol``, and for
            ``backend='torch'`` ``chunk_iters`` (4), ``state_path`` and
            ``max_wall_seconds``, as :func:`~gpcsd_tpu_torch.infer.map.map_fit`
            takes them.
        """
        del method  # only L-BFGS variants are supported, as in the reference
        options = options or {}
        fns = self._fns(fix_R=fix_R)
        res = map_fit(
            fns.neg_log_joint,
            fns.param_set,
            self._Y(),
            sample_restarts(fns.param_set, np.random.default_rng(seed), n_restarts),
            backend=backend,
            maxiter=options.get("maxiter", 1000),
            gtol=options.get("gtol", 1e-5),
            ftol=options.get("ftol", 1e7 * np.finfo(float).eps),
            verbose=verbose,
            chunk_iters=options.get("chunk_iters", 4),
            state_path=options.get("state_path"),
            max_wall_seconds=options.get("max_wall_seconds"),
        )
        theta = fns.param_set.unpack(torch.as_tensor(res.u_best))
        if fix_R:
            theta["R"] = self._tensor(self.R["value"])
        self._set_theta(theta)
        self.fit_result = res
        return res

    def predict(self, z, t, type="csd"):
        """Posterior mean CSD/LFP at locations z and times t.

        Sets ``csd_pred``/``csd_pred_list`` (and/or ``lfp_pred``,
        ``lfp_pred_list``), ``t_pred`` and ``x_pred`` as numpy arrays in the
        reference's (nz, ntstar, ntrials) layout and returns the total
        (the CSD for ``type="both"``).  ``type="lfp"`` predicts the LFP at
        ``z``, not at the data electrodes.
        """
        out = self.predict_tensors(z, t, type=type)
        for name in out:
            total, comps = out[name]
            setattr(self, f"{name}_pred", np.moveaxis(total.cpu().numpy(), 0, 2))
            setattr(self, f"{name}_pred_list",
                    [np.moveaxis(c.cpu().numpy(), 0, 2) for c in comps])
        self.t_pred = np.asarray(t, dtype=np.float64).reshape(-1, 1)
        self.x_pred = np.asarray(z, dtype=np.float64).reshape(-1, 1)
        return self.csd_pred if type in ("both", "csd") else self.lfp_pred

    def predict_tensors(self, z, t, type="csd"):
        """The predictions of :meth:`predict` as tensors on the model's
        device, set nowhere: ``{"csd": (total, [per component])}`` and/or
        ``"lfp"``, each (ntrials, nz, ntstar)."""
        if type not in ("csd", "lfp", "both"):
            raise ValueError(f"type must be 'csd', 'lfp' or 'both', got {type!r}")
        z = np.asarray(z, dtype=np.float64).reshape(-1, 1)
        theta = self._theta()
        sc = self.spatial_cov
        kphig = kphi = None
        with torch.no_grad():
            if type in ("both", "csd"):
                kphig = sc.compKphig_1d(z, theta["R"], device=self.device)
            if type in ("both", "lfp"):
                kphi = sc.compKphi_1d(theta["R"], xp=z, device=self.device)
            return posterior_predict(
                self._fns(), theta, self._Y(), kphig=kphig, kphi=kphi,
                t_data=self._tensor(self.t.reshape(-1)),
                t_star=self._tensor(np.asarray(t, dtype=np.float64).reshape(-1)),
            )

    def predict_variance(self, z, t, type="csd"):
        """Pointwise posterior variance of the CSD (or LFP) at (z, t), an
        (nz, ntstar) numpy array; fully factored (see
        :func:`gpcsd_tpu_torch.models.core.posterior_variance`)."""
        if type not in ("csd", "lfp"):
            raise ValueError(f"type must be 'csd' or 'lfp', got {type!r}")
        z = np.asarray(z, dtype=np.float64).reshape(-1, 1)
        theta = self._theta()
        sc = self.spatial_cov
        with torch.no_grad():
            if type == "csd":
                kxz = sc.compKphig_1d(z, theta["R"], device=self.device)
                prior_diag = torch.ones(z.shape[0], dtype=config.DTYPE, device=self.device)  # k(z,z)=1
            else:
                kxz = sc.compKphi_1d(theta["R"], xp=z, device=self.device)
                prior_diag = torch.diagonal(kphi_1d(
                    self._tensor(z.reshape(-1)), self._tensor(sc.gl_x), self._tensor(sc.gl_w),
                    theta["ell"], theta["R"],
                ))
            var = posterior_variance(
                self._fns(), theta, kxz, prior_diag,
                self._tensor(self.t.reshape(-1)), self._tensor(np.asarray(t).reshape(-1)),
            )
        return var.cpu().numpy()

    def predict_samples(self, z, t, n_draws=20, seed=0, trial=0,
                        method="auto", n_features=2048, draws=None):
        """Posterior CSD samples at (z, t) for one trial via Matheron's rule
        (:func:`gpcsd_tpu_torch.models.core.predict_samples`).

        :param method: spatial prior-draw factor: "exact" (Cholesky of the
            union kernel on z u quadrature nodes), "rff" (random Fourier
            features; the posterior correction stays exact, so only the
            prior carries the O(1/sqrt(n_features)) kernel approximation),
            or "auto" (exact up to 2000 union points, rff above).
        :param n_features: number of random features for method="rff".
        :param draws: a :class:`~gpcsd_tpu_torch.models.core.MatheronDraws`
            to use instead of drawing from ``default_rng(seed)``.
        :return: (n_draws, nz, ntstar) numpy array
        """
        z = np.asarray(z, dtype=np.float64).reshape(-1)
        sc = self.spatial_cov
        theta = self._theta()
        with torch.no_grad():
            return predict_samples(
                self._fns(), theta, self._Y()[trial],
                self._tensor(np.concatenate([z, sc.gl_x])), z.size,
                lambda u: se(u, u, theta["ell"]), theta["ell"], 1e-7,
                quad_weights_1d(
                    self._tensor(self.x.reshape(-1)), self._tensor(sc.gl_x),
                    self._tensor(sc.gl_w), theta["R"],
                ),
                sc.compKphig_1d(z, theta["R"], device=self.device),
                self.t.reshape(-1), np.asarray(t, dtype=np.float64).reshape(-1),
                n_draws, seed, method, n_features, draws,
            )

    def sample_prior(self, ntrials, seed=0):
        """Draw CSD prior samples, (nx, nt, ntrials) (``gpcsd1d.py:295-309``),
        from ``numpy.random.default_rng(seed)``."""
        with torch.no_grad():
            theta = self._theta()
            x = self._tensor(self.x.reshape(-1))
            Ks_csd = se(x, x, theta["ell"])
            Kt = self._fns().build_kt(theta)
            nx, nt = Ks_csd.shape[0], Kt.shape[0]
            eye = torch.eye(nx, dtype=config.DTYPE, device=self.device)
            Ls = torch.linalg.cholesky(Ks_csd + JITTER * eye)
            Lt = torch.linalg.cholesky(Kt)
            z = self._tensor(np.random.default_rng(seed).standard_normal((ntrials, nx, nt)))
            csd = Ls @ z @ Lt.mT
        return np.moveaxis(csd.cpu().numpy(), 0, 2)
