"""Adaptive tempered SMC with systematic resampling.

Counterpart of ``gpcsd_tpu.infer.smc``.  Sampler over the same unconstrained
density as NUTS/ADVI:

- particles initialized from the prior (via ``ParamSet.sample`` upstream);
- inverse-temperature ladder chosen adaptively by bisection so each stage's
  effective sample size stays near ``ess_target * n_particles``;
- systematic resampling; random-walk Metropolis mutation with the proposal
  scaled by the empirical particle covariance (diagonal, 2.38^2/d rule);
- log normalizing-constant estimate accumulated across stages (useful for
  model comparison; requires normalized priors).

The JAX package's ``lax.while_loop`` over stages is a Python loop here, with
the particle state on the device of ``particles0``.  The bisection runs on
the device, so the host reads the device once per stage (the new
temperature, which decides whether another stage follows);
:class:`SMCResult` carries the count.  The densities are evaluated without a
graph, in row chunks.

Random numbers are explicit: every stage consumes a :class:`StageNoise`,
drawn on the CPU from the caller's ``torch.Generator``
(:func:`draw_stage_noise`) or passed in, and moved to the device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch


class SMCResult(NamedTuple):
    particles: torch.Tensor  # (n_particles, dim)
    log_weights: torch.Tensor  # final (normalized) log weights
    log_evidence: torch.Tensor  # log normalizing constant estimate
    n_stages: int
    acceptance: torch.Tensor  # mean MH acceptance of the final stage
    temperatures: torch.Tensor | None = None  # (n_stages,) inverse temperatures reached
    log_evidence_increments: torch.Tensor | None = None  # (n_stages,)
    n_host_reads: int = 0  # host reads of device state over the run


class StageNoise(NamedTuple):
    """The random numbers one SMC stage consumes."""

    u_resample: torch.Tensor  # () uniform: the systematic resampler's offset
    xi: torch.Tensor  # (n_mutation_steps, n, dim) standard normals: the proposals
    u_accept: torch.Tensor  # (n_mutation_steps, n) uniforms: the MH tests


def draw_stage_noise(gen: torch.Generator, n: int, dim: int, n_mutation_steps: int) -> StageNoise:
    """One stage's :class:`StageNoise` from ``gen`` (float64, on the CPU)."""
    f64 = torch.float64
    return StageNoise(
        u_resample=torch.rand((), generator=gen, dtype=f64),
        xi=torch.randn(n_mutation_steps, n, dim, generator=gen, dtype=f64),
        u_accept=torch.rand(n_mutation_steps, n, generator=gen, dtype=f64),
    )


def _ess(log_w):
    w = torch.softmax(log_w, dim=-1)
    return 1.0 / torch.sum(torch.square(w))


def systematic_resample(u, log_w, n: int):
    """Systematic resampling from the uniform ``u`` in [0, 1); returns
    indices (n,).  An index that roundoff in the cumulative weights would
    put past the last particle is clamped onto it."""
    w = torch.softmax(log_w, dim=-1)
    positions = (u + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    idx = torch.searchsorted(torch.cumsum(w, dim=0), positions)
    return torch.clamp(idx, max=log_w.shape[0] - 1)


def _choose_delta(log_like, lam, ess_target_frac, n_iter=30):
    """Bisection for the largest temperature increment keeping ESS above
    target (Del Moral et al. adaptive tempering); on the device of
    ``log_like``, without a host read."""
    target = ess_target_frac * log_like.shape[0]
    hi0 = 1.0 - lam
    full_ok = _ess(hi0 * log_like) >= target
    lo, hi = torch.zeros_like(hi0), hi0
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        ok = _ess(mid * log_like) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(full_ok, hi0, torch.clamp(lo, min=1e-6))


def _eval_rows(fn: Callable, x, chunk: int | None = None):
    """``fn`` on the rows of ``x`` without a graph, ``chunk`` rows at a time
    (all at once when None)."""
    with torch.no_grad():
        if chunk is None or x.shape[0] <= chunk:
            return fn(x)
        return torch.cat([fn(x[i:i + chunk]) for i in range(0, x.shape[0], chunk)])


def smc_run(
    log_prior_fn: Callable,
    log_like_fn: Callable,
    particles0,
    gen: torch.Generator | None = None,
    n_mutation_steps: int = 10,
    ess_target_frac: float = 0.5,
    max_stages: int = 100,
    rw_scale: float = 1.0,
    chunk: int | None = None,
    noise: Sequence[StageNoise] | None = None,
) -> SMCResult:
    """Tempered SMC from the prior to prior x likelihood.

    :param log_prior_fn: ``(N, dim) -> (N,)`` (the bridging base density)
    :param log_like_fn: ``(N, dim) -> (N,)`` tempered component; a value
        that is not finite counts as -1e300
    :param particles0: (n_particles, dim) prior draws, on the device to run on
    :param gen: CPU generator of the stages' random numbers, unless
        ``noise`` gives them
    :param chunk: rows per call of the two evaluators (bounds the memory of
        a batched factorization)
    :param noise: per stage, a pre-drawn :class:`StageNoise`
    """
    particles = torch.as_tensor(particles0).detach()
    n, dim = particles.shape
    dtype, device = particles.dtype, particles.device

    def like(x):
        ll = _eval_rows(log_like_fn, x, chunk)
        return torch.where(torch.isfinite(ll), ll, -1e300)

    log_like = like(particles)
    log_prior = _eval_rows(log_prior_fn, particles, chunk)
    lam = torch.zeros((), dtype=dtype, device=device)
    log_evidence = torch.zeros((), dtype=dtype, device=device)
    acceptance = torch.zeros((), dtype=dtype, device=device)
    lams, increments = [], []
    stage, lam_host, n_host_reads = 0, 0.0, 0

    while lam_host < 1.0 and stage < max_stages:
        sn = noise[stage] if noise is not None else draw_stage_noise(gen, n, dim, n_mutation_steps)
        sn = StageNoise(*(torch.as_tensor(a).to(device=device, dtype=dtype) for a in sn))
        delta = _choose_delta(log_like, lam, ess_target_frac)
        lam = lam + delta

        # incremental weights and evidence update
        log_w = delta * log_like
        increment = torch.logsumexp(log_w, dim=0) - math.log(n)
        log_evidence = log_evidence + increment

        # resample
        idx = systematic_resample(sn.u_resample, log_w, n)
        particles, log_prior, log_like = particles[idx], log_prior[idx], log_like[idx]

        # random-walk MH mutation targeting prior * like^lam
        prop_sd = rw_scale * (2.38 / math.sqrt(dim)) * (
            torch.std(particles, dim=0, correction=0) + 1e-6
        )
        acc = torch.zeros((), dtype=dtype, device=device)
        for k in range(n_mutation_steps):
            prop = particles + prop_sd * sn.xi[k]
            lp_p = _eval_rows(log_prior_fn, prop, chunk)
            ll_p = like(prop)
            log_ratio = (lp_p + lam * ll_p) - (log_prior + lam * log_like)
            accept = torch.log(sn.u_accept[k]) < log_ratio
            particles = torch.where(accept[:, None], prop, particles)
            log_prior = torch.where(accept, lp_p, log_prior)
            log_like = torch.where(accept, ll_p, log_like)
            acc = acc + accept.to(dtype).mean()
        acceptance = acc / n_mutation_steps

        lams.append(lam)
        increments.append(increment)
        stage += 1
        lam_host = float(lam)
        n_host_reads += 1

    empty = torch.zeros(0, dtype=dtype, device=device)
    return SMCResult(
        particles=particles,
        log_weights=torch.zeros(n, dtype=dtype, device=device),  # equal weights post-resampling
        log_evidence=log_evidence,
        n_stages=stage,
        acceptance=acceptance,
        temperatures=torch.stack(lams) if lams else empty,
        log_evidence_increments=torch.stack(increments) if increments else empty,
        n_host_reads=n_host_reads,
    )
