"""Functional core: the log-joint functions, counterpart of ``gpcsd_tpu.models.core``.

Everything inference needs is assembled here as plain functions of a flat
unconstrained parameter vector ``u`` and the trial tensor ``Y``
(``(ntrials, nx, nt)``), the generalization of the reference's ``obj_fun``
closures (``gpcsd1d.py:153-191``).  The same ``log_prob`` serves MAP (as
``neg_log_joint``, no Jacobian, matching the reference objective) and the
samplers (with the log-det-Jacobian of the exp bijector).  Gradients come
from ``torch.autograd``.
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

    def build_kt(theta: Dict, t=None, tprime=None):
        tt = t_data if t is None else t
        tp = t_data if tprime is None else tprime
        total = 0.0
        for i, kind in enumerate(temporal_kinds):
            total = total + TEMPORAL_KERNELS[kind](
                tt, tp, theta[f"tm{i}_ell"], theta[f"tm{i}_sigma2"]
            )
        return total

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
        build_factors=build_factors,
        loglik=loglik,
        neg_log_joint=neg_log_joint,
        log_prob=log_prob,
        log_prior_u=log_prior_u,
        full_theta=full_theta,
    )
