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
per factor and one quadform call per row.
:func:`value_and_grad_rows` differentiates all rows in one backward.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from ..ops import kronlik
from ..ops.kernels import TEMPORAL_KERNELS
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

    def build_kt_components(theta: Dict, t=None, tprime=None):
        tt = t_data if t is None else t
        tp = t_data if tprime is None else tprime
        return [
            TEMPORAL_KERNELS[kind](tt, tp, theta[f"tm{i}_ell"], theta[f"tm{i}_sigma2"])
            for i, kind in enumerate(temporal_kinds)
        ]

    def build_kt(theta: Dict, t=None, tprime=None):
        return sum(build_kt_components(theta, t, tprime))

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

    def neg_log_joint(u, Y):
        theta = param_set.unpack(u)
        return -(loglik(theta, Y) + param_set.log_prior(theta) + fixed_log_prior)

    def log_prob(u, Y):
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
    )


def value_and_grad_rows(fn: Callable, u: torch.Tensor):
    """``fn(u)`` and its gradient for every row of ``u``.

    ``fn`` maps ``(C, dim)`` to ``(C,)`` with independent rows (as the
    batched ``log_prob`` does), so one backward of the sum gives all ``C``
    gradients.  Both results are detached, on the device of ``u``.

    :return: ``(values (C,), gradients (C, dim))``
    """
    u = u.detach().requires_grad_(True)
    f = fn(u)
    (g,) = torch.autograd.grad(f.sum(), u)
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
