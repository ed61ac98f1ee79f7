"""High-level posterior inference API of the model classes.

Counterpart of ``gpcsd_tpu.models.inference_api``: NUTS, ADVI and SMC over
the hyperparameters on the model's log-joint, returning *constrained*
per-name samples so downstream analysis never touches the unconstrained
space, the Laplace (MAP-Hessian) whitening that makes the 30-dimensional
paper posterior samplable, and WAIC / PSIS-LOO over a stored posterior.
With ``mesh=`` the three samplers run SPMD over the ranks of a
``(chain, trial)`` mesh (:mod:`gpcsd_tpu_torch.parallel`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..infer import model_comparison as mc
from ..infer.advi import advi_fit
from ..infer.diagnostics import ess_bulk, ess_tail, rhat
from ..infer.map import sample_restarts
from ..infer.nuts import chain_generators, nuts_chains
from ..infer.smc import smc_run
from ..utils.profiling import traced_call
from .core import ModelFns, value_and_grad_rows
from .reparam import AmplitudeReparam


class PosteriorSamples(NamedTuple):
    """Posterior over hyperparameters in constrained (natural) units."""

    theta: Dict[str, np.ndarray]  # name -> (nsamples[, size]) samples
    raw: object  # the engine's NUTSResult / ADVIResult / SMCResult (in unconstrained u)
    diagnostics: Dict[str, np.ndarray]


def laplace_hessian(fns: ModelFns, u_center, Y, h: float = 1e-4) -> np.ndarray:
    """Hessian of the negative log joint at ``u_center`` by central
    differences of its gradient, symmetrized; float64 on the device of
    ``Y``.

    All ``2 dim`` stencil points ``u +- h e_i`` go through the batched
    gradient (:func:`gpcsd_tpu_torch.models.core.value_and_grad_rows`) in
    one call.  Second-order autograd through the regularized ``eigh``
    backward is not used: that backward is not written to be
    differentiated again.

    :return: (dim, dim) numpy array
    """
    u = torch.tensor(np.asarray(u_center, dtype=np.float64), dtype=Y.dtype, device=Y.device)
    dim = u.shape[0]
    eye = h * torch.eye(dim, dtype=u.dtype, device=u.device)
    pts = torch.cat([u[None] + eye, u[None] - eye], dim=0)
    _, gs = value_and_grad_rows(lambda p: fns.neg_log_joint(p, Y), pts)
    H = ((gs[:dim] - gs[dim:]) / (2 * h)).T
    return (0.5 * (H + H.T)).cpu().numpy()


def load_hessian(H, dim=None) -> np.ndarray:
    """A precomputed Hessian as a (dim, dim) float64 numpy array: from an
    array (numpy, or anything ``np.asarray`` takes) or the path of an
    ``.npz`` with key ``H``.  Raises when it is not square of size ``dim``."""
    if isinstance(H, (str, bytes)):
        with np.load(H) as d:
            H = d["H"]
    H = np.asarray(H, dtype=np.float64)
    if H.ndim != 2 or H.shape[0] != H.shape[1] or (dim is not None and H.shape[0] != dim):
        want = "square" if dim is None else f"({dim}, {dim})"
        raise ValueError(f"laplace_hessian has shape {H.shape}, expected {want}")
    return H


def whitening_from_hessian(H):
    """``(A, A_inv)`` with ``A = H^{-1/2}`` from the floored
    eigendecomposition of the symmetric ``H`` (numpy, float64).

    Saddle-free: ``|curvature|`` is used, so a direction of negative
    curvature (a centre that is not exactly the mode) gets its actual
    scale and not an astronomically wide one, with a floor of 1e-6 of the
    stiffest mode for flat directions.
    """
    w, V = np.linalg.eigh(np.asarray(H, dtype=np.float64))
    wmax = float(np.max(np.abs(w)))
    w = np.maximum(np.abs(w), 1e-6 * max(wmax, 1e-30))
    A = (V * (1.0 / np.sqrt(w))[None, :]) @ V.T
    A_inv = (V * np.sqrt(w)[None, :]) @ V.T
    return A, A_inv


def _laplace_maps(fns, u_center, Y, H, J=None):
    """``(A, A_inv)`` of the whitening at ``u_center``: from the precomputed
    ``H`` (array or ``.npz`` path), or from :func:`laplace_hessian` when
    ``H`` is None.  With ``J = du/dr`` at the centre the u-space Hessian is
    pulled back to the reparameterized space as ``J^T H J`` (the transform
    is unimodular, so there is no log-det curvature term, and the gradient
    term vanishes at the mode to the order the Laplace whitening assumes)."""
    if H is None:
        H = laplace_hessian(fns, u_center, Y)
    else:
        H = load_hessian(H, u_center.shape[0])
    H = 0.5 * (H + H.T)
    if J is not None:
        H = J.T @ H @ J
    return whitening_from_hessian(H)


def stream_generator(seed: int, k: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from ``(seed, k)``: stream ``k`` of
    an entry point's random numbers."""
    state = np.random.SeedSequence([seed, k]).generate_state(1, dtype=np.uint64)[0]
    return torch.Generator().manual_seed(int(state >> np.uint64(1)))


def prior_starts(fns: ModelFns, seed: int, n: int, fixed=None) -> np.ndarray:
    """(n, dim) prior draws in u clipped into the parameter box, from
    ``numpy.random.default_rng([seed, 0])``: the samplers' starts, with or
    without a mesh.  ``fixed`` pins constrained values
    (:func:`~gpcsd_tpu_torch.infer.map.sample_restarts`)."""
    return sample_restarts(fns.param_set, np.random.default_rng([seed, 0]), n, fixed=fixed)


class InferenceAPIMixin:
    """Mixin adding ``sample_posterior``, ``advi``, ``smc`` and
    ``information_criteria`` to model classes.

    Host classes provide ``_fns(fix_R=...)``, ``_Y()``, ``_theta()``,
    ``_set_theta(theta)`` and ``device``.
    """

    def _constrain_batch(self, fns, u_batch):
        """(N, dim) unconstrained -> dict of (N,) or (N, size) numpy arrays."""
        theta = fns.param_set.unpack(torch.as_tensor(u_batch, dtype=torch.float64))
        return {k: v.numpy() for k, v in theta.items()}

    def _pack_batch(self, fns, theta):
        """Dict of (N,) or (N, size) constrained numpy arrays -> (N, dim)
        unconstrained; the inverse of :meth:`_constrain_batch`."""
        ps = fns.param_set
        return np.concatenate([
            np.log(np.asarray(theta[name], dtype=np.float64).reshape(
                -1, ps.specs[name].size) / ps.specs[name].scale)
            for name in ps.names
        ], axis=1)

    @traced_call("gpcsd.sample_posterior")
    def sample_posterior(
        self,
        n_chains=4,
        num_warmup=500,
        num_samples=500,
        seed=0,
        fix_R=False,
        max_depth=10,
        target_accept=0.8,
        mesh=None,
        set_posterior_mean=False,
        pool_warmup=False,
        callback=None,
        init="params_jitter",
        laplace=None,
        laplace_hessian=None,
        dense_mass=False,
        reparam=None,
        state_path=None,
        save_every=1,
    ) -> PosteriorSamples:
        """NUTS posterior over hyperparameters, chains batched on the
        model's device.

        :param mesh: a ``(chain, trial)`` mesh
            (:func:`gpcsd_tpu_torch.parallel.mesh.make_mesh`): every rank of
            the default group calls this with the same arguments, and
            :func:`gpcsd_tpu_torch.parallel.sharded.nuts_sharded` runs the
            chains split over ``chain`` and the trials over ``trial``, from
            prior draws, unwhitened.  ``pool_warmup``, ``callback``,
            ``laplace``, ``reparam`` and ``state_path`` are refused there;
            ``init`` and ``laplace_hessian`` do not apply.  A rank outside the
            mesh gets None and stores nothing.
        :param set_posterior_mean: write posterior-mean params back into the
            model (analogous to ``fit`` writing back the MAP).
        :param pool_warmup: share mass-matrix adaptation statistics across
            chains during warmup.
        :param callback: ``callback(i, carry)`` after every transition.
        :param init: chain initialization.  ``"params_jitter"`` (default)
            starts chains at the model's current parameters (run ``fit``
            first so this is the MAP) with a per-chain jitter;
            ``"prior"`` draws starts from the priors.  Prior draws can sit
            millions of log-units from the posterior bulk at real problem
            sizes, and warmup spent descending that cliff diverges
            constantly and poisons step-size adaptation.
        :param laplace: (None: on without a mesh) sample in the
            MAP-Hessian-whitened space
            ``u = u0 + H^{-1/2} v`` (run ``fit`` first so the centre is the
            MAP).  The hyperparameter posterior at real data sizes is a
            strongly correlated ridge that a diagonal mass matrix cannot
            whiten; whitening makes it near-isotropic.  Exact (a constant
            linear reparameterization).
        :param laplace_hessian: precomputed Hessian of the negative log
            joint at the current parameters: a (dim, dim) array or a path
            to an ``.npz`` with key ``H``.  Computed by
            :func:`laplace_hessian` when None.
        :param dense_mass: adapt a full-covariance metric during warmup
            (Stan's dense_e) instead of the diagonal one.  Composes with
            ``laplace``: whitening supplies the static linear map, the
            dense metric learns the residual correlations.
        :param reparam: ``"amplitude"`` samples in coordinates where the
            model's mean per-channel LFP signal variance is an axis
            (:mod:`gpcsd_tpu_torch.models.reparam`), removing the curved
            forward-amplitude ridge at the source.  The map is a
            closed-form unimodular bijection, so the sampled density needs
            no Jacobian correction; whitening and the dense metric compose
            on top.
        :param state_path: checkpoint file stem: the sampler saves its
            state there every ``save_every`` transitions, before
            ``callback`` runs, and a rerun with the same arguments
            continues from it with the same draws bit for bit.
        """
        fns = self._fns(fix_R=fix_R)
        Y = self._Y()
        if mesh is not None:
            # the sharded driver has no pooling, checkpointing or whitening:
            # refuse rather than silently drop what the caller asked for
            asked = {"pool_warmup": pool_warmup, "state_path": state_path,
                     "callback": callback, "laplace": laplace, "reparam": reparam}
            bad = [k for k, v in asked.items() if v]
            if bad:
                raise ValueError(f"sample_posterior(mesh=...) does not support {bad}; "
                                 "these are single-device options")
            from ..parallel.sharded import nuts_sharded

            res = nuts_sharded(fns, Y, mesh, seed, n_chains, num_warmup=num_warmup,
                               num_samples=num_samples, max_depth=max_depth,
                               target_accept=target_accept, dense_mass=dense_mass)
            if res is None:
                return None
            return self._store_nuts(fns, res, set_posterior_mean)

        if laplace is None:
            laplace = True
        dev, f64 = self.device, torch.float64
        u_center = fns.param_set.pack(self._theta()).cpu().numpy()
        dim = u_center.shape[0]

        def on_device(fn):
            """A map on (..., dim) tensors as a map on numpy rows."""
            def wrapped(a):
                with torch.no_grad():
                    out = fn(torch.as_tensor(a, dtype=f64, device=dev).reshape(-1, dim))
                return out.cpu().numpy().reshape(np.shape(a))
            return wrapped

        if reparam == "amplitude":
            rp = AmplitudeReparam(fns)
            from_r_t = rp.inverse
            to_r, from_r = on_device(rp.forward), on_device(rp.inverse)
        elif reparam:
            raise ValueError(f"unknown reparam {reparam!r}")
        else:
            rp = None
            to_r = from_r = from_r_t = lambda x: x  # noqa: E731
        center = to_r(u_center)

        if laplace:
            J = None
            if rp is not None:
                J = torch.autograd.functional.jacobian(
                    rp.inverse, torch.as_tensor(center, dtype=f64, device=dev)
                ).cpu().numpy()
            A, A_inv = _laplace_maps(fns, u_center, Y, laplace_hessian, J)
        else:
            A = A_inv = np.eye(dim)

        # u = from_r(center + A v) (A symmetric); identity maps when neither
        # whitened nor reparameterized
        def from_u(u):
            return (to_r(u) - center) @ A_inv

        def to_u(v):
            return from_r(center + v @ A)

        if init == "params_jitter":
            # in whitened space the posterior sd is ~1, so unit-scale
            # jitter gives properly overdispersed starts; unwhitened falls
            # back to small u-space jitter
            scale = 1.0 if laplace else 0.05
            rng = np.random.default_rng([seed, 0])
            # keep starts inside the parameter box (clip in u-space)
            u0s = fns.param_set.clip_to_bounds(torch.as_tensor(
                to_u(scale * rng.standard_normal((n_chains, dim))))).numpy()
        elif init == "prior":
            u0s = prior_starts(fns, seed, n_chains)
        else:
            raise ValueError(f"unknown init {init!r}")
        v0s = from_u(u0s)

        A_t = torch.as_tensor(A, dtype=f64, device=dev)
        c_t = torch.as_tensor(center, dtype=f64, device=dev)
        res = nuts_chains(
            lambda v: fns.log_prob(from_r_t(c_t + v @ A_t), Y),
            torch.as_tensor(v0s, dtype=f64, device=dev),
            chain_generators(seed, n_chains),
            num_warmup=num_warmup,
            num_samples=num_samples,
            max_depth=max_depth,
            target_accept=target_accept,
            pool_warmup=pool_warmup,
            callback=callback,
            dense_mass=dense_mass,
            state_path=state_path,
            save_every=save_every,
        )
        # map the samples back to u-space: linear when only whitened, through
        # the nonlinear inverse when reparameterized
        with torch.no_grad():
            r = (c_t + res.samples @ A_t).reshape(-1, dim)
            res = res._replace(samples=from_r_t(r).reshape(res.samples.shape))
        return self._store_nuts(fns, res, set_posterior_mean)

    def _store_nuts(self, fns, res, set_posterior_mean):
        """Store the ``NUTSResult`` ``res`` (draws in u) with its diagnostics
        as the model's :class:`PosteriorSamples`, and return it."""
        n_chains, num_samples, dim = res.samples.shape
        samples = res.samples.cpu().numpy()
        flat = samples.reshape(-1, dim)
        diagnostics = {
            "accept_prob": res.accept_prob.cpu().numpy(),
            "num_steps": res.num_steps.cpu().numpy(),
            "diverging": res.diverging.cpu().numpy(),
            "step_size": res.step_size.cpu().numpy(),
        }
        if n_chains > 1 and num_samples > 3:
            names = fns.param_set.names_flat()
            diagnostics["rhat"] = dict(zip(names, rhat(samples)))
            diagnostics["ess"] = dict(zip(names, ess_bulk(samples)))
            diagnostics["ess_tail"] = dict(zip(names, ess_tail(samples)))
        if set_posterior_mean:
            mean_u = torch.as_tensor(flat.mean(axis=0), dtype=torch.float64, device=self.device)
            self._set_theta(fns.full_theta(fns.param_set.unpack(mean_u)))
        self.posterior = PosteriorSamples(
            theta=self._constrain_batch(fns, flat), raw=res, diagnostics=diagnostics
        )
        return self.posterior

    def advi(self, num_steps=3000, n_mc=8, learning_rate=0.02, seed=0, fix_R=False,
             n_draws=1000, mesh=None) -> PosteriorSamples:
        """Mean-field ADVI posterior approximation, started at a prior draw
        clipped into the parameter box.

        :param mesh: a ``(chain, trial)`` mesh: the trial terms summed over
            its ``trial`` axis (:func:`gpcsd_tpu_torch.parallel.sharded.advi_sharded`),
            the same start and draws.  None and nothing stored on a rank
            outside it.
        """
        fns = self._fns(fix_R=fix_R)
        Y = self._Y()
        if mesh is None:
            u0 = torch.as_tensor(prior_starts(fns, seed, 1)[0], device=self.device)
            res = advi_fit(
                lambda u: fns.log_prob(u, Y), u0, stream_generator(seed, 1),
                num_steps=num_steps, n_mc=n_mc, learning_rate=learning_rate,
            )
        else:
            from ..parallel.sharded import advi_sharded

            res = advi_sharded(fns, Y, mesh, seed, num_steps=num_steps, n_mc=n_mc,
                               learning_rate=learning_rate)
            if res is None:
                return None
        draws = res.sample(stream_generator(seed, 2), n_draws).cpu().numpy()
        self.posterior = PosteriorSamples(
            theta=self._constrain_batch(fns, draws),
            raw=res,
            diagnostics={"elbo": res.elbo_trace.cpu().numpy()},
        )
        return self.posterior

    def smc(self, n_particles=1024, n_mutation_steps=10, seed=0, fix_R=False,
            batch=64, mesh=None) -> PosteriorSamples:
        """Adaptive tempered SMC posterior (prior -> posterior).

        :param batch: particles per batched evaluation of the prior and
            the likelihood (bounds the memory of the batched factors).
        :param mesh: a ``(chain, trial)`` mesh: particle likelihoods split
            over its ``chain`` axis (``batch`` rows at a time within a
            rank's block) and trial terms summed over ``trial``
            (:func:`gpcsd_tpu_torch.parallel.sharded.smc_sharded`;
            ``n_particles`` padded up to a multiple of the chain size).  None
            and nothing stored on a rank outside it.
        """
        fns = self._fns(fix_R=fix_R)
        Y = self._Y()
        if mesh is None:
            particles0 = torch.as_tensor(prior_starts(fns, seed, n_particles), device=self.device)
            res = smc_run(
                fns.log_prior_u,
                lambda u: fns.loglik(fns.param_set.unpack(u), Y),
                particles0, stream_generator(seed, 1),
                n_mutation_steps=n_mutation_steps, chunk=batch,
            )
        else:
            from ..parallel.sharded import smc_sharded

            res = smc_sharded(fns, Y, mesh, seed, n_particles=n_particles,
                              n_mutation_steps=n_mutation_steps, chunk=batch)
            if res is None:
                return None
        self.posterior = PosteriorSamples(
            theta=self._constrain_batch(fns, res.particles.cpu().numpy()),
            raw=res,
            diagnostics={
                "log_evidence": res.log_evidence.cpu().numpy(),
                "n_stages": np.asarray(res.n_stages),
                "acceptance": res.acceptance.cpu().numpy(),
            },
        )
        return self.posterior

    def information_criteria(self, method="both", max_draws=256, seed=0, batch=8, fix_R=False):
        """Fully-Bayesian model comparison criteria over the stored
        posterior: WAIC and/or PSIS-LOO with per-trial pointwise terms
        (:mod:`gpcsd_tpu_torch.infer.model_comparison`).  Run
        ``sample_posterior`` / ``advi`` / ``smc`` first; works with any of
        them because it reconstructs unconstrained draws from the
        constrained ``posterior.theta`` dict.

        :param method: ``"waic"``, ``"loo"``, or ``"both"``.
        :param max_draws: posterior draws used (subsampled without
            replacement: pointwise likelihood is O(draws * ntrials)).
        :returns: dict with keys among {"waic", "loo"}; LOO includes the
            per-trial Pareto k-hat reliability diagnostic.
        """
        if getattr(self, "posterior", None) is None:
            raise RuntimeError("no posterior stored: run sample_posterior/advi/smc first")
        fns = self._fns(fix_R=fix_R)
        us = self._pack_batch(fns, self.posterior.theta)
        n = us.shape[0]
        if n > max_draws:
            us = us[np.random.default_rng(seed).choice(n, max_draws, replace=False)]
        ll = mc.pointwise_loglik(fns, us, self._Y(), batch=batch)
        out = {"n_draws": int(us.shape[0])}
        if method in ("waic", "both"):
            out["waic"] = mc.waic(ll)
        if method in ("loo", "both"):
            out["loo"] = mc.psis_loo(ll)
        return out
