"""GPCSD2D: 2D (planar probe) Gaussian-process CSD model.

Counterpart of ``gpcsd_tpu.models.gpcsd2d``, with the reference's API
(``gpcsd2d.py``: constructor defaults ``:20-79``, ``loglik`` ``:136-151``,
``fit`` ``:153-287``, ``predict`` ``:289-334``, ``sample_prior``
``:336-360``, param round-trip ``:103-125``).  Same functional engine as
:class:`~gpcsd_tpu_torch.models.gpcsd1d.GPCSD1D`; the differences are the
product-SE spatial covariance with two lengthscales, the singularity offset
``eps``, jitter 1e-7, and the sig2n bounds (max 10).  It runs on the
model's ``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..infer.map import map_fit, sample_restarts
from ..ops.kernels import se_2d, sq_diffs_2d
from ..ops.spatial import kphi_2d, pairwise_w, quad_weights_2d
from ..utils.grids import reduce_grid
from ..utils.profiling import traced_call
from .core import (
    ModelFns,
    make_model_fns,
    posterior_predict,
    posterior_variance,
    predict_samples,
)
from .covariances import (
    GPCSD2DSpatialCovSE,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
    _interval_prior,
    _prior_draw,
)
from .inference_api import InferenceAPIMixin
from .params import ParamSet, ParamSpec
from .priors import HalfNormal

JITTER = config.JITTER_2D


class GPCSD2D(InferenceAPIMixin):
    def __init__(
        self,
        lfp,
        x,
        t,
        a1=None,
        b1=None,
        a2=None,
        b2=None,
        ngl1=20,
        ngl2=60,
        spatial_cov=None,
        temporal_cov_list=None,
        R_prior=None,
        sig2n_prior=None,
        eps=None,
        het_noise="approx",
        device=config.DEFAULT_DEVICE,
        gen=None,
    ):
        """
        :param lfp: LFP array, shape (n_spatial_lfp, n_time, n_trials)
        :param x: observed spatial locations (n_spatial_lfp, 2), microns
        :param t: observed time points (n_time, 1), milliseconds
        :param a1,b1,a2,b2: integration bounds per dimension (default data range)
        :param ngl1, ngl2: Gauss-Legendre orders per dimension
        :param eps: forward-model singularity offset (default 5*min spacing)
        :param het_noise: per-channel-noise likelihood mode: "approx"
            (reference parity) or "exact" (noise-whitened factorization);
            ignored for scalar noise
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
        self.x = np.asarray(x, dtype=np.float64)
        self.t = np.asarray(t, dtype=np.float64).reshape(-1, 1)
        a1 = float(np.min(self.x[:, 0])) if a1 is None else a1
        b1 = float(np.max(self.x[:, 0])) if b1 is None else b1
        a2 = float(np.min(self.x[:, 1])) if a2 is None else a2
        b2 = float(np.max(self.x[:, 1])) if b2 is None else b2
        self.a1, self.b1, self.a2, self.b2 = a1, b1, a2, b2
        self.ngl1, self.ngl2 = int(ngl1), int(ngl2)
        if spatial_cov is None:
            spatial_cov = GPCSD2DSpatialCovSE(
                self.x, a1=a1, b1=b1, a2=a2, b2=b2, ngl1=self.ngl1, ngl2=self.ngl2, gen=gen
            )
        self.spatial_cov = spatial_cov
        if temporal_cov_list is None:
            temporal_cov_list = [
                GPCSDTemporalCovSE(self.t, gen=gen),
                GPCSDTemporalCovMatern(self.t, gen=gen),
            ]
        self.temporal_cov_list = temporal_cov_list
        x1, x2 = reduce_grid(self.x)
        min_delta_x = float(min(np.min(np.diff(x1)), np.min(np.diff(x2))))
        max_delta_x = float(max(b1 - a1, b2 - a2))
        if R_prior is None:
            R_prior = _interval_prior(min_delta_x, 0.5 * max_delta_x)
        self.R = {
            "value": _prior_draw(R_prior, gen),
            "prior": R_prior,
            "min": 0.5 * min_delta_x,
            "max": 0.8 * max_delta_x,
        }
        self.eps = float(5 * min_delta_x) if eps is None else float(eps)
        if sig2n_prior is None:
            sig2n_prior = HalfNormal(1.0)
        if isinstance(sig2n_prior, list):
            self.sig2n = {
                "value": np.array([_prior_draw(sp, gen) for sp in sig2n_prior]),
                "prior": sig2n_prior,
                "min": [1e-8] * len(sig2n_prior),
                "max": [10.0] * len(sig2n_prior),
            }
        else:
            self.sig2n = {
                "value": _prior_draw(sig2n_prior, gen),
                "prior": sig2n_prior,
                "min": 1e-8,
                "max": 10.0,
            }
        self._fns_cache = {}

    # ------------------------------------------------------------------ API

    def __str__(self):
        s = "GPCSD2D object\n"
        s += "LFP shape: (%d, %d, %d)\n" % self.lfp.shape
        s += "Integration bounds: (%d, %d), (%d, %d)\n" % (self.a1, self.b1, self.a2, self.b2)
        s += "Integration number points: %d, %d\n" % (self.ngl1, self.ngl2)
        s += "R parameter prior: %s\n" % str(self.R["prior"])
        s += "R parameter value %0.4g\n" % self.R["value"]
        for dim in ("ell1", "ell2"):
            p = self.spatial_cov.params[dim]
            s += "Spatial covariance %s prior: %s\n" % (dim, str(p["prior"]))
            s += "Spatial covariance %s value %0.4g\n" % (dim, p["value"])
        for i, tc in enumerate(self.temporal_cov_list):
            s += "Temporal covariance %d class name: %s\n" % (i + 1, type(tc).__name__)
            s += "Temporal covariance %d ell value %0.4g\n" % (i + 1, tc.params["ell"]["value"])
            s += "Temporal covariance %d sigma2 value %0.4g\n" % (i + 1, tc.params["sigma2"]["value"])
        return s

    def extract_model_params(self):
        """Reference-schema param dict (``gpcsd2d.py:103-113``)."""
        return {
            "R": self.R["value"],
            "eps": self.eps,
            "sig2n": self.sig2n["value"],
            "spatial_ell1": self.spatial_cov.params["ell1"]["value"],
            "spatial_ell2": self.spatial_cov.params["ell2"]["value"],
            "temporal_ell_list": [tc.params["ell"]["value"] for tc in self.temporal_cov_list],
            "temporal_sigma2_list": [
                tc.params["sigma2"]["value"] for tc in self.temporal_cov_list
            ],
        }

    def restore_model_params(self, params):
        if len(self.temporal_cov_list) != len(params["temporal_ell_list"]):
            raise ValueError("different number of temporal covariance functions!")
        self.R["value"] = params["R"]
        self.eps = params["eps"]
        self.sig2n["value"] = params["sig2n"]
        self.spatial_cov.params["ell1"]["value"] = params["spatial_ell1"]
        self.spatial_cov.params["ell2"]["value"] = params["spatial_ell2"]
        for i, tc in enumerate(self.temporal_cov_list):
            tc.params["ell"]["value"] = params["temporal_ell_list"][i]
            tc.params["sigma2"]["value"] = params["temporal_sigma2_list"][i]

    def update_lfp(self, new_lfp, t, x=None):
        """Replace the data (and its time points, and optionally the
        electrode positions), keeping the parameter values."""
        if x is not None:
            self.x = np.asarray(x, dtype=np.float64)
            self.spatial_cov.reset_x(self.x)
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
            "ell1": self._tensor(self.spatial_cov.params["ell1"]["value"]),
            "ell2": self._tensor(self.spatial_cov.params["ell2"]["value"]),
        }
        for i, tc in enumerate(self.temporal_cov_list):
            theta[f"tm{i}_ell"] = self._tensor(tc.params["ell"]["value"])
            theta[f"tm{i}_sigma2"] = self._tensor(tc.params["sigma2"]["value"])
        theta["sig2n"] = self._tensor(self.sig2n["value"])
        return theta

    def _set_theta(self, theta):
        self.R["value"] = float(theta["R"])
        self.spatial_cov.params["ell1"]["value"] = float(theta["ell1"])
        self.spatial_cov.params["ell2"]["value"] = float(theta["ell2"])
        for i, tc in enumerate(self.temporal_cov_list):
            tc.params["ell"]["value"] = float(theta[f"tm{i}_ell"])
            tc.params["sigma2"]["value"] = float(theta[f"tm{i}_sigma2"])
        s = np.asarray(theta["sig2n"].detach().cpu())
        self.sig2n["value"] = s if s.ndim else float(s)

    def _param_set(self, fix_R=False) -> ParamSet:
        """Parameter order matches the reference tparams vector
        (``gpcsd2d.py:161-175``): R, ell1, ell2, per-temporal (ell, sigma2),
        sig2n; R and the spatial lengthscales carry the /100 scaling."""
        specs = {}
        if not fix_R:
            specs["R"] = ParamSpec(
                prior=self.R["prior"], lo=self.R["min"], hi=self.R["max"], scale=100.0
            )
        for dim in ("ell1", "ell2"):
            p = self.spatial_cov.params[dim]
            specs[dim] = ParamSpec(prior=p["prior"], lo=p["min"], hi=p["max"], scale=100.0)
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
        key = (fix_R, self.het_noise, self.eps, self.lfp.shape, self.t.shape[0],
               float(self.t[0, 0]), float(self.t[-1, 0]))
        if key in self._fns_cache:
            return self._fns_cache[key]
        sc = self.spatial_cov
        delta_w, gl_xy, gl_w = sc.geometry(self.device)
        # the node-to-node squared differences do not depend on the
        # parameters: at 3600 nodes they are two 104 MB tensors that every
        # evaluation would otherwise rebuild (and autograd keep)
        gl_sq = sq_diffs_2d(gl_xy, gl_xy)
        eps = self.eps
        jitter_eye = JITTER * torch.eye(self.x.shape[0], dtype=config.DTYPE, device=self.device)

        def build_ks(theta):
            return kphi_2d(
                delta_w, gl_xy, gl_w, theta["ell1"], theta["ell2"], theta["R"], eps, gl_sq=gl_sq
            ) + jitter_eye

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
        profile=False,
        options=None,
    ):
        """Multi-restart MAP fit (reference default maxiter=500,
        ``gpcsd2d.py:153-154``); writes the best parameters back in place.

        Restart draws come from ``numpy.random.default_rng(seed)``.
        :param backend: 'torch' (all restarts in one batched L-BFGS run on
            the model's device) or 'scipy' (serial L-BFGS-B).
        :param profile: instead of fitting, profile one objective call and
            one gradient call with cProfile at one prior draw, into the
            files ``objfunstats`` and ``gradobjfunstats`` of the working
            directory, and return None (the reference's hook,
            ``gpcsd2d.py:242-247``); the parameters are left as they are.
        :param options: ``maxiter`` (500), ``gtol``, ``ftol``, and for
            ``backend='torch'`` ``chunk_iters`` (4), ``state_path`` and
            ``max_wall_seconds``, as :func:`~gpcsd_tpu_torch.infer.map.map_fit`
            takes them.
        """
        del method  # only L-BFGS variants are supported, as in the reference
        options = options or {}
        fns = self._fns(fix_R=fix_R)
        if profile:
            self._profile_objective(fns, seed)
            return None
        res = map_fit(
            fns.neg_log_joint,
            fns.param_set,
            self._Y(),
            sample_restarts(fns.param_set, np.random.default_rng(seed), n_restarts),
            backend=backend,
            maxiter=options.get("maxiter", 500),
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

    def _profile_objective(self, fns, seed):
        """cProfile of one value and one gradient of the MAP objective at a
        prior draw from ``numpy.random.default_rng(seed)``, after a warm-up;
        on the card each profiled statement ends in a synchronize."""
        import cProfile

        Y = self._Y()
        u0 = fns.param_set.pack(fns.param_set.sample(np.random.default_rng(seed))).to(self.device)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)

        def f(u):
            with torch.no_grad():
                return fns.neg_log_joint(u, Y)

        def gf(u):
            u = u.detach().requires_grad_(True)
            return torch.autograd.grad(fns.neg_log_joint(u, Y), u)[0]

        f(u0), gf(u0), sync()  # warm up outside the profile
        cProfile.runctx("f(u0); sync()", None, locals(), filename="objfunstats")
        cProfile.runctx("gf(u0); sync()", None, locals(), filename="gradobjfunstats")

    def predict(self, z, t, type="csd"):
        """Posterior mean CSD/LFP at (nz, 2) locations z and times t.

        Sets ``csd_pred``/``csd_pred_list`` (and/or ``lfp_pred``,
        ``lfp_pred_list``), ``t_pred`` and ``x_pred`` as numpy arrays in the
        reference's (nz, ntstar, ntrials) layout and returns the total
        (the CSD for ``type="both"``).
        """
        if type not in ("csd", "lfp", "both"):
            raise ValueError(f"type must be 'csd', 'lfp' or 'both', got {type!r}")
        z = np.asarray(z, dtype=np.float64)
        tstar = np.asarray(t, dtype=np.float64).reshape(-1, 1)
        theta = self._theta()
        sc = self.spatial_cov
        kphig = kphi = None
        with torch.no_grad():
            if type in ("both", "csd"):
                kphig = sc.compKphig_2d(z, theta["R"], self.eps, device=self.device)
            if type in ("both", "lfp"):
                kphi = sc.compKphi_2d(theta["R"], self.eps, xp=z, device=self.device)
            out = posterior_predict(
                self._fns(), theta, self._Y(), kphig=kphig, kphi=kphi,
                t_data=self._tensor(self.t.reshape(-1)),
                t_star=self._tensor(tstar.reshape(-1)),
            )
        for name in out:
            total, comps = out[name]
            setattr(self, f"{name}_pred", np.moveaxis(total.cpu().numpy(), 0, 2))
            setattr(self, f"{name}_pred_list",
                    [np.moveaxis(c.cpu().numpy(), 0, 2) for c in comps])
        self.t_pred = tstar
        self.x_pred = z
        return self.csd_pred if type in ("both", "csd") else self.lfp_pred

    def predict_variance(self, z, t, type="csd"):
        """Pointwise posterior variance at (nz, 2) locations z and times t;
        an (nz, ntstar) numpy array (see
        :func:`gpcsd_tpu_torch.models.core.posterior_variance`)."""
        if type not in ("csd", "lfp"):
            raise ValueError(f"type must be 'csd' or 'lfp', got {type!r}")
        z = np.asarray(z, dtype=np.float64)
        theta = self._theta()
        sc = self.spatial_cov
        with torch.no_grad():
            if type == "csd":
                kxz = sc.compKphig_2d(z, theta["R"], self.eps, device=self.device)
                # product-SE correlation: k(z, z) = 1
                prior_diag = torch.ones(z.shape[0], dtype=config.DTYPE, device=self.device)
            else:
                kxz = sc.compKphi_2d(theta["R"], self.eps, xp=z, device=self.device)
                _, gl_xy, gl_w = sc.geometry(self.device)
                prior_diag = torch.diagonal(kphi_2d(
                    pairwise_w(self._tensor(z), gl_xy), gl_xy, gl_w,
                    theta["ell1"], theta["ell2"], theta["R"], self.eps,
                ))
            var = posterior_variance(
                self._fns(), theta, kxz, prior_diag,
                self._tensor(self.t.reshape(-1)), self._tensor(np.asarray(t).reshape(-1)),
            )
        return var.cpu().numpy()

    def predict_samples(self, z, t, n_draws=20, seed=0, trial=0,
                        method="auto", n_features=2048, draws=None):
        """Posterior CSD samples at (nz, 2) locations z via Matheron's rule
        (see :meth:`GPCSD1D.predict_samples`).  method="exact" builds a
        Cholesky on the z u quadrature grid; method="rff" (chosen by "auto"
        above 2000 union points, e.g. the Neuropixels 30 x 120 rule) draws
        the prior through a random-Fourier-feature expansion of the product
        SE kernel, keeping the posterior correction exact.

        :return: (n_draws, nz, ntstar) numpy array
        """
        z = np.asarray(z, dtype=np.float64)
        sc = self.spatial_cov
        theta = self._theta()
        ell1, ell2 = theta["ell1"], theta["ell2"]
        with torch.no_grad():
            delta_w, gl_xy, gl_w = sc.geometry(self.device)
            return predict_samples(
                self._fns(), theta, self._Y()[trial],
                torch.cat([self._tensor(z), gl_xy], dim=0), z.shape[0],
                lambda u: se_2d(u, u, ell1, ell2), torch.stack([ell1, ell2]), 1e-6,
                quad_weights_2d(delta_w, gl_w, theta["R"], self.eps),
                sc.compKphig_2d(z, theta["R"], self.eps, device=self.device),
                self.t.reshape(-1), np.asarray(t, dtype=np.float64).reshape(-1),
                n_draws, seed, method, n_features, draws,
            )

    def sample_prior(self, ntrials, type="csd", seed=1, normals=None):
        """Prior CSD and/or (experimental) LFP draws from
        ``numpy.random.default_rng(seed)``; returns ``(csd, lfp)``, each
        (nx, nt, ntrials), with NaNs for the branch not requested, matching
        ``gpcsd2d.py:336-360``.  Both branches share one set of normals.

        :param normals: (ntrials, nx, nt) standard normals to use in place of
            the generator's draws (pre-drawn numbers, as ``draws=`` of
            :meth:`predict_samples`), or None."""
        nx, nt = self.x.shape[0], self.t.shape[0]
        out = {"csd": np.nan * np.zeros((nx, nt, ntrials)),
               "lfp": np.nan * np.zeros((nx, nt, ntrials))}
        with torch.no_grad():
            theta = self._theta()
            Lt = torch.linalg.cholesky(self._fns().build_kt(theta))
            if normals is None:
                normals = np.random.default_rng(seed).standard_normal((ntrials, nx, nt))
            elif np.shape(normals) != (ntrials, nx, nt):
                raise ValueError(f"normals must have shape {(ntrials, nx, nt)}, got {np.shape(normals)}")
            z = self._tensor(normals)
            eye = torch.eye(nx, dtype=config.DTYPE, device=self.device)
            x = self._tensor(self.x)
            spatial = {}
            if type in ("csd", "both"):
                spatial["csd"] = se_2d(x, x, theta["ell1"], theta["ell2"])
            if type in ("lfp", "both"):
                spatial["lfp"] = self.spatial_cov.compKphi_2d(
                    theta["R"], self.eps, device=self.device)
            for name, Ks in spatial.items():
                Ls = torch.linalg.cholesky(Ks + JITTER * eye)
                out[name] = np.moveaxis((Ls @ z @ Lt.mT).cpu().numpy(), 0, 2)
        return out["csd"], out["lfp"]
