"""Functional core: the log-joint functions, counterpart of ``gpcsd_tpu.models.core``.

Everything inference needs is assembled here as plain functions of a flat
unconstrained parameter vector ``u`` and the trial tensor ``Y``
(``(ntrials, nx, nt)``), the generalization of the reference's ``obj_fun``
closures (``gpcsd1d.py:153-191``).  The same ``log_prob`` serves MAP (as
``neg_log_joint``, no Jacobian, matching the reference objective) and the
samplers (with the log-det-Jacobian of the exp bijector).  Gradients come
from ``torch.autograd``.

Where the JAX package maps these functions over chains or stencil points
with ``jax.vmap``, here the batch is written out: ``log_prob``,
``neg_log_joint`` and ``log_prior_u`` take ``u`` of shape ``(dim,)`` or
``(C, dim)`` and return a scalar or ``(C,)``, with one batched ``eigh``
per factor and one quadform call per row: each row has its own factors,
so the per-trial kernel (``quadform_rows``, one ``(qs, qt, dinv)`` for all
its trials) does not apply here.
:func:`value_and_grad_rows` differentiates all rows in one backward; on the
card its passes of ``log_prob`` and ``neg_log_joint`` replay CUDA graphs
around the eager factorization (:mod:`gpcsd_tpu_torch.models.pass_graphs`).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from ..ops import kronlik
from ..ops.kernels import TEMPORAL_KERNELS
from ..ops.rff import rff_draws, se_rff_features
from ..utils.profiling import count, pass_span, span
from . import pass_graphs
from .params import ParamSet


class ModelFns(NamedTuple):
    """Bundle of plain functions for one model configuration."""

    param_set: ParamSet
    build_ks: Callable  # theta -> (nx, nx) LFP-LFP spatial cov (incl. jitter)
    build_kt: Callable  # theta, t, tprime -> (nt, ntp) summed temporal cov
    build_kt_components: Callable  # theta, t, tprime -> list of (nt, ntp)
    build_factors: Callable  # theta -> KronFactors (eig of Ks, Kt, + noise)
    loglik: Callable  # theta, Y -> scalar
    neg_log_joint: Callable  # u, Y -> scalar  (MAP objective, no Jacobian)
    log_prob: Callable  # u, Y -> scalar  (posterior density in u-space)
    log_prior_u: Callable  # u -> scalar prior + jacobian (no likelihood)
    full_theta: Callable  # theta -> theta merged with fixed params
    graphs: pass_graphs.PassGraphs  # the value+grad passes' CUDA graphs


def temporal_param_names(n_components: int):
    """The (ell, sigma2) parameter names of each temporal component."""
    return [(f"tm{i}_ell", f"tm{i}_sigma2") for i in range(n_components)]


def build_kt_fns(temporal_kinds, t_data: torch.Tensor):
    """Temporal covariance stack ``K_t = sum_i K_t^i`` (reference
    ``gpcsd1d.py:118-120``): ``(build_kt, build_kt_components)``, each
    ``(theta, t=None, tprime=None)`` with ``t``/``tprime`` defaulting to the
    (nt,) data times ``t_data``."""
    names = temporal_param_names(len(temporal_kinds))

    def build_kt_components(theta: Dict, t=None, tprime=None):
        tt = t_data if t is None else t
        tp = t_data if tprime is None else tprime
        return [
            TEMPORAL_KERNELS[kind](tt, tp, theta[ell], theta[sigma2])
            for kind, (ell, sigma2) in zip(temporal_kinds, names)
        ]

    def build_kt(theta: Dict, t=None, tprime=None):
        return sum(build_kt_components(theta, t, tprime))

    return build_kt, build_kt_components


def make_model_fns(
    param_set: ParamSet,
    build_ks,
    temporal_kinds,
    t_data: torch.Tensor,
    fixed: Dict | None = None,
    fixed_log_prior: float = 0.0,
    het_exact: bool = False,
) -> ModelFns:
    """Assemble the function bundle given a spatial-cov function.

    :param build_ks: ``theta -> (nx, nx)`` including jitter.
    :param temporal_kinds: keys of :data:`TEMPORAL_KERNELS`, one per
        temporal component ``tm{i}``; ``K_t = sum_i K_t^i``.
    :param t_data: (nt,) data times on the model's device.
    :param fixed: constrained parameter values held constant (e.g. ``fix_R``,
        reference ``gpcsd1d.py:160-162``); merged into every unpacked theta.
    :param fixed_log_prior: constant prior mass of the fixed params, added
        so reported NLLs match the reference, which sums all priors.
    :param het_exact: with per-channel sig2n, use the exact noise-whitened
        factorization instead of the reference's eigenbasis approximation.
    """
    fixed = dict(fixed or {})

    def full_theta(theta: Dict) -> Dict:
        return {**theta, **fixed} if fixed else theta

    build_kt, build_kt_components = build_kt_fns(temporal_kinds, t_data)

    def build_factors(theta: Dict):
        theta = full_theta(theta)
        return kronlik.comp_eig_d(
            build_ks(theta), build_kt(theta), theta["sig2n"], het_exact=het_exact
        )

    def loglik(theta: Dict, Y):
        return kronlik.loglik(build_factors(theta), Y)

    def log_prior_u(u):
        theta = param_set.unpack(u)
        return param_set.log_prior(theta) + fixed_log_prior + param_set.log_det_jacobian(u)

    # the two halves of a pass that pass_graphs captures, around the eager
    # eigh calls: the same ops as log_prob / neg_log_joint below, in their order
    def inputs_half(u):
        theta = full_theta(param_set.unpack(u))
        Ks, Kt = build_ks(theta), build_kt(theta)
        sig2n = torch.as_tensor(theta["sig2n"], dtype=Ks.dtype, device=Ks.device)
        return kronlik.spatial_eigh_input(Ks, sig2n, het_exact), Kt

    def factors_half(objective, ntrials, lam_t, lam_s, u, qs=None):
        theta = param_set.unpack(u)
        sig2n = torch.as_tensor(full_theta(theta)["sig2n"], dtype=u.dtype, device=u.device)
        f = kronlik.factors_from_eigenpairs(lam_t, None, lam_s, qs, sig2n, het_exact)
        prior = param_set.log_prior(theta)
        if objective == "log_prob":
            prior = prior + fixed_log_prior + param_set.log_det_jacobian(u)
        out = (f.d, kronlik.logdet_term(f, ntrials), prior)
        return out if qs is None else out + (f.qs,)

    sig2n_spec = param_set.specs["sig2n"]
    graphs = pass_graphs.PassGraphs(inputs_half, factors_half,
                                    whitened=het_exact and sig2n_spec.size > 1,
                                    fixed_log_prior=fixed_log_prior)

    def neg_log_joint(u, Y):
        value = graphs.run("neg_log_joint", u, Y)
        if value is not None:
            return value
        theta = param_set.unpack(u)
        return -(loglik(theta, Y) + param_set.log_prior(theta) + fixed_log_prior)

    def log_prob(u, Y):
        value = graphs.run("log_prob", u, Y)
        if value is not None:
            return value
        return loglik(param_set.unpack(u), Y) + log_prior_u(u)

    return ModelFns(
        param_set=param_set,
        build_ks=build_ks,
        build_kt=build_kt,
        build_kt_components=build_kt_components,
        build_factors=build_factors,
        loglik=loglik,
        neg_log_joint=neg_log_joint,
        log_prob=log_prob,
        log_prior_u=log_prior_u,
        full_theta=full_theta,
        graphs=graphs,
    )


def value_and_grad_rows(fn: Callable, u: torch.Tensor):
    """``fn(u)`` and its gradient for every row of ``u``.

    ``fn`` maps ``(C, dim)`` to ``(C,)`` with independent rows (as the
    batched ``log_prob`` does), so one backward of the sum gives all ``C``
    gradients.  Both results are detached, on the device of ``u``.

    Every batched pass of the program (the samplers, the optimizer, the
    Laplace Hessian, the shift stage) goes through here: it is counted
    (``pass.count``, ``pass.rows``) and traced (span ``gpcsd.pass``, its
    backward's host interval ``gpcsd.pass.backward``).  On the card the
    ``log_prob`` and ``neg_log_joint`` calls inside ``fn`` may replay CUDA
    graphs (:mod:`gpcsd_tpu_torch.models.pass_graphs`); the results are
    then copies, never a graph's buffers, which the next replay overwrites.

    :return: ``(values (C,), gradients (C, dim))``
    """
    rows = u.shape[0]
    count("pass.count")
    count("pass.rows", rows)
    with pass_span(rows):
        u = u.detach().requires_grad_(True)
        with pass_graphs.engaged() as graphed:
            f = fn(u)
        with span("gpcsd.pass.backward"):
            (g,) = torch.autograd.grad(f.sum(), u)
    if graphed["replayed"]:
        return f.detach().clone(), g.clone()
    return f.detach(), g


def posterior_predict(fns: ModelFns, theta: Dict, Y, kphig=None, kphi=None,
                      t_data=None, t_star=None):
    """Factored posterior mean prediction per temporal component.

    Returns a dict with optional keys ``'csd'`` and ``'lfp'``, each a tuple
    ``(total, per_component_list)`` of tensors (ntrials, nz, ntstar).
    Mirrors reference ``GPCSD1D.predict`` (``gpcsd1d.py:248-293``) through
    :func:`gpcsd_tpu_torch.ops.kronlik.kron_solve`: no dense Kronecker
    product is formed.

    :param kphig: (nx, nz) LFP-CSD spatial cross-covariance, or None
    :param kphi: (nx, nz) LFP-LFP spatial cross-covariance, or None
    :param t_data, t_star: data and prediction times, tensors on the
        device of ``Y``
    """
    V = kronlik.kron_solve(fns.build_factors(theta), Y)
    kt_stars = fns.build_kt_components(theta, t=t_data, tprime=t_star)
    out = {}
    for name, kxz in (("csd", kphig), ("lfp", kphi)):
        if kxz is None:
            continue
        comps = [kronlik.kron_cross_mean(kxz, kts, V) for kts in kt_stars]
        out[name] = (sum(comps), comps)
    return out


def posterior_variance(fns: ModelFns, theta: Dict, kxz, prior_spatial_diag,
                       t_data, t_star):
    """Pointwise posterior variance of the (total) latent field at the
    prediction grid, fully factored: with cross-covariance
    ``c = kxz[:, i] (x) ktt[:, j]``,

        var_ij = prior_ij - sum_ab (Qs^T kxz)_ai^2 (Qt^T ktt)_bj^2 / D_ab

    i.e. two small congruences plus one (nx, nt) x (nt, ntstar) matmul
    chain, never the (nx*nt)^2 joint covariance.

    :param kxz: (nx, nz) spatial cross-covariance to the target field
    :param prior_spatial_diag: (nz,) prior spatial variance at the targets
    :param t_data, t_star: data and prediction times, tensors on the
        device of ``kxz``
    :return: (nz, ntstar) variance tensor
    """
    fac = fns.build_factors(theta)
    ktt = fns.build_kt(theta, t=t_data, tprime=t_star)
    # prior temporal variance at t_star (sum of component variances)
    kt_star_diag = torch.diagonal(fns.build_kt(theta, t=t_star, tprime=t_star))
    prior = prior_spatial_diag[:, None] * kt_star_diag[None, :]
    As = torch.square(fac.qs.mT @ kxz)  # (nx, nz)
    At = torch.square(fac.qt.mT @ ktt)  # (nt, ntstar)
    return prior - As.mT @ (1.0 / fac.d) @ At


class MatheronDraws(NamedTuple):
    """Every random number one ``predict_samples`` call consumes (numpy)."""

    eps: np.ndarray  # (n_draws, n_latent, n_time_union) standard normals: the prior field
    noise: np.ndarray  # (n_draws, nx, nt) standard normals: the observation noise
    w_unit: np.ndarray | None = None  # (d, n_features) normals, method "rff" only
    b: np.ndarray | None = None  # (n_features,) uniforms on [0, 2 pi), "rff" only


def sample_method(method: str, n_union: int) -> str:
    """``"exact"`` or ``"rff"``; ``"auto"`` is exact up to 2000 union points
    (prediction sites plus quadrature nodes) and rff above."""
    if method == "auto":
        return "rff" if n_union > 2000 else "exact"
    if method not in ("exact", "rff"):
        raise ValueError(f"unknown method {method!r}")
    return method


def matheron_draws(seed, n_draws, n_latent, n_time_union, nx, nt, rff_dim=None) -> MatheronDraws:
    """Draw a :class:`MatheronDraws` from ``numpy.random.default_rng(seed)``.

    :param n_latent: columns of the spatial prior factor: the number of
        union points (exact) or of random features (rff)
    :param rff_dim: spatial dimension of the random features, or None for
        the exact method
    """
    gen = np.random.default_rng(seed)
    eps = gen.standard_normal((n_draws, n_latent, n_time_union))
    noise = gen.standard_normal((n_draws, nx, nt))
    if rff_dim is None:
        return MatheronDraws(eps, noise)
    return MatheronDraws(eps, noise, *rff_draws(gen, rff_dim, n_latent))


def matheron_samples(fns: ModelFns, theta: Dict, y_obs, Ls, A, kphig, t_data, t_star,
                     same_grid: bool, draws: MatheronDraws):
    """Posterior CSD samples for one trial by Matheron's rule (pathwise
    conditioning).

    Draw (c*, y') jointly from the prior: the CSD on the union grid
    z u (quadrature nodes), pushed through the quadrature operator ``A``
    plus noise for y'; then correct, ``c* + Kzy Kyy^{-1} (y - y')``.
    Everything stays factored.  With prediction times off the data grid the
    joint prior is drawn on the union time grid t* u t_data (separable, so
    one temporal Cholesky of size nt* + nt covers both blocks).

    :param y_obs: (nx, nt) the trial conditioned on
    :param Ls: (nz + ngl, n_latent) spatial prior factor on the union grid,
        prediction sites first
    :param A: (nx, ngl) quadrature operator
    :param kphig: (nx, nz) LFP-CSD cross-covariance
    :param same_grid: whether ``t_star`` is the data grid itself
    :return: (n_draws, nz, ntstar) tensor
    """
    nz, nt, nts = kphig.shape[1], t_data.numel(), t_star.numel()
    dev = y_obs.device
    if same_grid:
        t_union = t_data
        sl_star = sl_data = slice(0, nt)
    else:
        t_union = torch.cat([t_star, t_data])
        sl_star, sl_data = slice(0, nts), slice(nts, nts + nt)
    Kt_u = fns.build_kt(theta, t=t_union, tprime=t_union)
    # off the data grid a relative jitter keeps the Cholesky stable even
    # when t* overlaps data times (exactly duplicated rows)
    jit_t = 1e-10 if same_grid else 1e-8 * torch.mean(torch.diagonal(Kt_u)) + 1e-12
    Lt = torch.linalg.cholesky(
        Kt_u + jit_t * torch.eye(t_union.numel(), dtype=Kt_u.dtype, device=dev)
    )
    eps = torch.as_tensor(draws.eps, dtype=Ls.dtype, device=dev)
    noise = torch.as_tensor(draws.noise, dtype=Ls.dtype, device=dev)
    prior_fields = Ls @ eps @ Lt.mT
    c_star = prior_fields[:, :nz, sl_star]  # CSD prior draws at (z, t*)
    csd_gl = prior_fields[:, nz:, sl_data]  # CSD at (quadrature nodes, t_data)
    sig2n = fns.full_theta(theta)["sig2n"]
    y_prior = A @ csd_gl + torch.sqrt(torch.atleast_1d(sig2n))[:, None] * noise
    V = kronlik.kron_solve(fns.build_factors(theta), y_obs[None] - y_prior)
    Kt_cross = fns.build_kt(theta, t=t_data, tprime=t_star)
    return c_star + kronlik.kron_cross_mean(kphig, Kt_cross, V)


def predict_samples(fns: ModelFns, theta: Dict, y_obs, union, nz, prior_gram, ells, jitter,
                    A, kphig, t_data, t_star, n_draws, seed, method, n_features, draws=None):
    """The model classes' ``predict_samples``: choose the spatial prior
    factor (:func:`sample_method`), draw (:func:`matheron_draws`, unless
    ``draws`` is given) and sample (:func:`matheron_samples`).

    :param union: prediction sites then quadrature nodes, (n,) or (n, d),
        a tensor on the model's device; ``nz`` of them are sites
    :param prior_gram: ``union -> (n, n)`` SE correlation (method "exact",
        factored by Cholesky with ``jitter`` on the diagonal)
    :param ells: the SE lengthscale, or a (d,) tensor of them (method "rff")
    :param t_data, t_star: numpy time vectors
    :return: (n_draws, nz, ntstar) numpy array
    """
    n_union, dev = union.shape[0], union.device
    nx, nt = y_obs.shape
    method = sample_method(method, n_union)
    same_grid = np.array_equal(t_star, t_data)
    if draws is None:
        draws = matheron_draws(
            seed, n_draws, n_features if method == "rff" else n_union,
            nt if same_grid else t_star.size + nt, nx, nt,
            rff_dim=(1 if union.ndim == 1 else union.shape[1]) if method == "rff" else None,
        )
    if method == "exact":
        eye = torch.eye(n_union, dtype=union.dtype, device=dev)
        Ls = torch.linalg.cholesky(prior_gram(union) + jitter * eye)
    else:
        Ls = se_rff_features(union, ells, draws.w_unit, draws.b)
    out = matheron_samples(
        fns, theta, y_obs, Ls, A, kphig,
        torch.as_tensor(t_data, dtype=union.dtype, device=dev),
        torch.as_tensor(t_star, dtype=union.dtype, device=dev), same_grid, draws,
    )
    return out.cpu().numpy()
