"""Shared HMC machinery: leapfrog, dual averaging, Welford mass adaptation.

Counterpart of ``gpcsd_tpu.infer.hmc``.  The JAX package writes these for
one chain and maps them over chains with ``jax.vmap``; here every state
carries the chain axis itself: positions, momenta and gradients are
``(C, dim)``, step sizes, energies and counters ``(C,)``, and the inverse
mass is ``(C, dim)`` (diagonal metric) or ``(C, dim, dim)`` (dense).  The
per-chain arithmetic is row-wise (no product over the chain axis), so a
chain's numbers do not depend on which other chains share the batch.

Random numbers come in as arguments (standard normals ``xi``), drawn by
the caller from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import config
from ..utils.profiling import count


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor  # (C,)
    log_step_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor  # (C,) int64


def da_init(step_size: torch.Tensor) -> DualAveragingState:
    """Dual-averaging state started at ``step_size`` ((C,) float64)."""
    log_step = torch.log(step_size)
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=log_step.clone(),
        h_sum=torch.zeros_like(log_step),
        mu=math.log(10.0) + log_step,
        count=torch.zeros(log_step.shape, dtype=torch.int64, device=log_step.device),
    )


def da_update(state: DualAveragingState, accept_prob, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75) -> DualAveragingState:
    """Nesterov dual averaging on log step size (Hoffman & Gelman 2014)."""
    count = state.count + 1
    n = count.to(state.h_sum.dtype)
    w = 1.0 / (n + t0)
    h_sum = (1.0 - w) * state.h_sum + w * (target - accept_prob)
    log_step = state.mu - torch.sqrt(n) / gamma * h_sum
    eta = n ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(
        log_step=log_step, log_step_avg=log_step_avg, h_sum=h_sum,
        mu=state.mu, count=count,
    )


class WelfordState(NamedTuple):
    mean: torch.Tensor  # (..., dim)
    m2: torch.Tensor  # (..., dim)
    count: torch.Tensor  # (...,) int64


def welford_init(dim: int, batch=(), dtype=torch.float64,
                 device=config.DEFAULT_DEVICE) -> WelfordState:
    device = config.get_device(device)
    shape = tuple(batch) + (dim,)
    return WelfordState(
        mean=torch.zeros(shape, dtype=dtype, device=device),
        m2=torch.zeros(shape, dtype=dtype, device=device),
        count=torch.zeros(tuple(batch), dtype=torch.int64, device=device),
    )


def welford_update(state: WelfordState, x) -> WelfordState:
    count = state.count + 1
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean=mean, m2=m2, count=count)


def welford_variance(state: WelfordState, regularize=True):
    n = torch.clamp(state.count, min=1).to(state.m2.dtype)[..., None]
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    if regularize:  # Stan's shrinkage toward unit metric
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def _matvec(m, r):
    """Row-wise ``m[c] @ r[c]`` as a multiply and a sum over the last axis
    (no batched GEMM, whose kernel choice may depend on the batch size)."""
    return torch.sum(m * r[..., None, :], dim=-1)


def mass_velocity(inv_mass, r):
    """``M^{-1} r`` under either metric representation: ``inv_mass`` is
    ``(C, dim)`` (diagonal metric, the default) or ``(C, dim, dim)`` (a
    dense posterior-covariance estimate, Stan's dense_e); ``r`` is
    ``(C, dim)``."""
    if inv_mass.ndim == r.ndim + 1:
        return _matvec(inv_mass, r)
    return inv_mass * r


def draw_momentum(xi, inv_mass):
    """``r ~ N(0, M)`` with ``M = inv_mass^{-1}`` from standard normals
    ``xi`` (C, dim): elementwise scaling for a diagonal metric, a
    triangular solve against ``chol(inv_mass)`` for a dense one
    (``cov(r) = inv_mass^{-1}``)."""
    if inv_mass.ndim == xi.ndim + 1:
        # trace-scaled jitter (same guard as dense_metric.metric_from_cov):
        # dense_welford_cov's shrinkage keeps the adapted metric SPD, but a
        # caller-supplied rank-deficient covariance would otherwise give
        # NaNs out of the Cholesky
        dim = inv_mass.shape[-1]
        trace = torch.diagonal(inv_mass, dim1=-2, dim2=-1).sum(-1)
        scale = torch.clamp(trace / dim, min=1e-300)[..., None, None]
        eye = torch.eye(dim, dtype=inv_mass.dtype, device=inv_mass.device)
        L = torch.linalg.cholesky(inv_mass + 1e-12 * scale * eye)
        return torch.linalg.solve_triangular(L.mT, xi[..., None], upper=True)[..., 0]
    return xi / torch.sqrt(inv_mass)


def leapfrog(vg: Callable, z, r, grad, step_size, inv_mass):
    """One leapfrog step for every row; returns ``(z, r, logp, grad)``.

    ``vg`` maps ``(C, dim)`` positions to ``(logp (C,), grad (C, dim))``;
    ``step_size`` is ``(C,)`` and signed (negative integrates backward).
    """
    eps = step_size[:, None]
    r = r + 0.5 * eps * grad
    z = z + eps * mass_velocity(inv_mass, r)
    logp, grad = vg(z)
    r = r + 0.5 * eps * grad
    return z, r, logp, grad


def kinetic(r, inv_mass):
    if inv_mass.ndim == r.ndim + 1:
        return 0.5 * torch.sum(r * _matvec(inv_mass, r), dim=-1)
    return 0.5 * torch.sum(torch.square(r) * inv_mass, dim=-1)


def find_reasonable_step_size(vg, z, xi, inv_mass, init=1.0):
    """Heuristic initial step size per chain (Hoffman & Gelman 2014,
    Algorithm 4): double or halve from ``init`` until the one-step
    acceptance ratio crosses 1/2.  Chains move in lock-step; one that has
    crossed keeps its step while the others go on (at most 50 moves)."""
    logp0, grad0 = vg(z)
    r = draw_momentum(xi, inv_mass)
    h0 = -logp0 + kinetic(r, inv_mass)

    def joint(step):
        _, r1, logp1, _ = leapfrog(vg, z, r, grad0, step, inv_mass)
        la = h0 - (-logp1 + kinetic(r1, inv_mass))  # log accept ratio
        return torch.where(torch.isfinite(la), la, -torch.inf)

    half = math.log(0.5)
    step = torch.full_like(logp0, init)
    la = joint(step)
    up = la > half
    factor = torch.where(up, 2.0, 0.5)
    active = torch.ones_like(up)
    for _ in range(50):
        active = active & torch.where(up, la > half, la < half) & (step > 1e-10) & (step < 1e7)
        count("host_sync.hmc.step_search")
        if not bool(active.any()):
            break
        step = torch.where(active, step * factor, step)
        la = joint(step)
    return step


def stan_warmup_schedule(num_warmup: int, init_buffer=75, term_buffer=50, base_window=25):
    """Boolean masks over warmup steps: (in_slow_window, window_end_flags).

    ``slow_mask[i]`` marks steps whose positions feed the mass-matrix
    estimator and ``window_end[i]`` marks the last step of each slow window
    (where the metric is refreshed and dual averaging restarts).
    """
    slow_mask = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    if num_warmup < 20:
        return slow_mask, window_end
    if init_buffer + term_buffer + base_window > num_warmup:
        # compress: keep proportions (Stan does similar)
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.1 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    start = init_buffer
    size = base_window
    while start < num_warmup - term_buffer:
        end = start + size
        next_size = size * 2
        # final window absorbs the remainder
        if end + next_size > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        slow_mask[start:end] = True
        window_end[end - 1] = True
        start = end
        size = next_size
    return slow_mask, window_end
