"""High-level posterior inference API of the model classes.

Counterpart of ``gpcsd_tpu.models.inference_api``: NUTS over the
hyperparameters on the model's log-joint, returning *constrained* per-name
samples so downstream analysis never touches the unconstrained space, and
the Laplace (MAP-Hessian) whitening that makes the 30-dimensional paper
posterior samplable.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..infer.diagnostics import ess_bulk, ess_tail, rhat
from ..infer.nuts import chain_generators, nuts_chains
from .core import ModelFns, value_and_grad_rows


class PosteriorSamples(NamedTuple):
    """Posterior over hyperparameters in constrained (natural) units."""

    theta: Dict[str, np.ndarray]  # name -> (nsamples[, size]) samples
    raw: object  # the sampler's NUTSResult (samples in unconstrained u)
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


def _laplace_maps(fns, u_center, Y, H):
    """``(A, A_inv)`` of the whitening at ``u_center``: from the precomputed
    ``H`` (array or ``.npz`` path), or from :func:`laplace_hessian` when
    ``H`` is None."""
    if H is None:
        H = laplace_hessian(fns, u_center, Y)
    else:
        H = load_hessian(H, u_center.shape[0])
    return whitening_from_hessian(0.5 * (H + H.T))


class InferenceAPIMixin:
    """Mixin adding ``sample_posterior`` to model classes.

    Host classes provide ``_fns(fix_R=...)``, ``_Y()``, ``_theta()``,
    ``_set_theta(theta)`` and ``device``.
    """

    def _constrain_batch(self, fns, u_batch):
        """(N, dim) unconstrained -> dict of (N,) or (N, size) numpy arrays."""
        theta = fns.param_set.unpack(torch.as_tensor(u_batch, dtype=torch.float64))
        return {k: v.numpy() for k, v in theta.items()}

    def sample_posterior(
        self,
        n_chains=4,
        num_warmup=500,
        num_samples=500,
        seed=0,
        fix_R=False,
        max_depth=10,
        target_accept=0.8,
        set_posterior_mean=False,
        pool_warmup=False,
        callback=None,
        init="params_jitter",
        laplace=True,
        laplace_hessian=None,
        dense_mass=False,
    ) -> PosteriorSamples:
        """NUTS posterior over hyperparameters, chains batched on the
        model's device.

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
        :param laplace: sample in the MAP-Hessian-whitened space
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
        """
        fns = self._fns(fix_R=fix_R)
        Y = self._Y()
        dev, f64 = self.device, torch.float64
        u_center = fns.param_set.pack(self._theta()).cpu().numpy()
        dim = u_center.shape[0]

        if laplace:
            A, A_inv = _laplace_maps(fns, u_center, Y, laplace_hessian)
        else:
            A = A_inv = np.eye(dim)

        # u = u_center + A v (A symmetric); identity maps when not whitened
        def from_u(u):
            return (u - u_center) @ A_inv

        def to_u(v):
            return u_center + v @ A

        rng = np.random.default_rng([seed, 0])
        if init == "params_jitter":
            # in whitened space the posterior sd is ~1, so unit-scale
            # jitter gives properly overdispersed starts; unwhitened falls
            # back to small u-space jitter
            scale = 1.0 if laplace else 0.05
            u0s = to_u(scale * rng.standard_normal((n_chains, dim)))
        elif init == "prior":
            u0s = np.stack([
                fns.param_set.pack(fns.param_set.sample(rng)).numpy() for _ in range(n_chains)
            ])
        else:
            raise ValueError(f"unknown init {init!r}")
        # keep starts inside the parameter box (clip in u-space)
        v0s = from_u(fns.param_set.clip_to_bounds(torch.as_tensor(u0s)).numpy())

        A_t = torch.as_tensor(A, dtype=f64, device=dev)
        c_t = torch.as_tensor(u_center, dtype=f64, device=dev)
        res = nuts_chains(
            lambda v: fns.log_prob(c_t + v @ A_t, Y),
            torch.as_tensor(v0s, dtype=f64, device=dev),
            chain_generators(seed, n_chains),
            num_warmup=num_warmup,
            num_samples=num_samples,
            max_depth=max_depth,
            target_accept=target_accept,
            pool_warmup=pool_warmup,
            callback=callback,
            dense_mass=dense_mass,
        )
        # map whitened samples back to u-space
        res = res._replace(samples=c_t + res.samples @ A_t)

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
            mean_u = torch.as_tensor(flat.mean(axis=0), dtype=f64, device=dev)
            self._set_theta(fns.full_theta(fns.param_set.unpack(mean_u)))
        self.posterior = PosteriorSamples(
            theta=self._constrain_batch(fns, flat), raw=res, diagnostics=diagnostics
        )
        return self.posterior
