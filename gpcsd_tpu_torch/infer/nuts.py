"""Iterative multi-chain NUTS (No-U-Turn Sampler) on batched tensors.

Counterpart of ``gpcsd_tpu.infer.nuts`` (``_build_subtree``,
``nuts_transition``, ``nuts_run``, ``nuts_chains``, ``_pool_welford_chains``,
``stepsize_floor_guard``).  The algorithm is the JAX package's:

- *Iterative* tree building: the recursive NUTS of Hoffman & Gelman (2014)
  with O(max_depth) checkpoint buffers.  Sub-U-turn checks use the
  trailing-bits scheme: a height-h subtree ending at leaf n
  (h <= trailing_ones(n)) starts at s = n+1-2^h whose checkpoint lives in
  slot popcount(s); the slots checked at leaf n form the contiguous range
  [popcount(n+1)-1, popcount(n+1)-2+t].
- Multinomial (progressive) sampling within subtrees, biased progressive
  sampling across doublings, generalized U-turn criterion
  ``dot(rho, v_end) <= 0`` (Betancourt 2017), diagonal or dense metric.
- Warmup: dual averaging to ``target_accept`` + Welford (or dense Welford)
  mass adaptation on the Stan three-phase window schedule.

Chains in lock-step.  JAX runs one chain's two nested ``while_loop``s
under ``jax.vmap``: the loops run until every chain is done, and a chain
whose own condition has failed keeps its state.  Here the chain axis is
written out.  All chains still in a loop are at the same depth and leaf
(both start at 0 and advance by one per pass), so ``depth`` and ``n`` are
Python ints and the checkpoint-slot arithmetic is done once per pass.  Each
pass gathers the rows of the chains still active, takes ONE batched
leapfrog on them, and writes the results back to those rows only: a
finished chain's state is never touched, and a finished chain costs no
log-density evaluation.  Every per-chain quantity is computed row-wise, so
a chain's draws do not depend on which other chains share the batch.  One
host read (which rows are active) per leapfrog.

Random numbers are explicit.  A transition consumes a
:class:`TransitionNoise` per chain, drawn by the caller
(:func:`draw_noise`) from that chain's own ``torch.Generator``.

The chunk programs, padding and ahead-of-time cache of
``nuts_chains_chunked`` are not carried over: they exist for the TPU
worker's compile times.  Its ``state_path`` resume is, at the grain of one
transition: :func:`nuts_chains` saves everything the loop carries,
the chains' generator states included, so a run that is stopped and started
again gives the draws of an uninterrupted one bit for bit.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import config
from ..io.checkpoint import load_sampler_state, sampler_state_exists, save_sampler_state
from ..models.core import value_and_grad_rows
from ..utils.profiling import count, span
from .dense_metric import (
    dense_welford_cov,
    dense_welford_init,
    dense_welford_update,
)
from .hmc import (
    da_init,
    da_update,
    draw_momentum,
    find_reasonable_step_size,
    kinetic,
    leapfrog,
    mass_velocity,
    stan_warmup_schedule,
    welford_init,
    welford_update,
    welford_variance,
)

MAX_DELTA_ENERGY = 1000.0

#: With ``pool_warmup``, the chains' Welford statistics are pooled after
#: every this many warmup transitions (the JAX package pools at its chunk
#: boundaries; this is its default chunk size).
POOL_EVERY = 10

#: Rows of the log-density whose value and gradient :func:`nuts_chains` has
#: evaluated since import (a caller may reset it to 0): the sampler's own
#: count of evaluations, the step-size search and warmup included.
evaluations = 0


class TransitionNoise(NamedTuple):
    """The random numbers one NUTS transition consumes, per chain."""

    xi: torch.Tensor  # (C, dim) standard normals: the momentum draw
    dirs: torch.Tensor  # (C, max_depth) +-1: direction of each doubling
    u_leaf: torch.Tensor  # (C, max_depth, 2**(max_depth-1)) uniforms, [depth, n]
    u_doubling: torch.Tensor  # (C, max_depth) uniforms, one per doubling


def chain_generators(seed: int, n_chains: int):
    """One CPU ``torch.Generator`` per chain, seeded from ``(seed, chain)``,
    so a chain's random stream is the same whatever runs beside it."""
    seeds = np.random.SeedSequence(seed).generate_state(n_chains, dtype=np.uint64)
    return [torch.Generator().manual_seed(int(s >> np.uint64(1))) for s in seeds]


def draw_noise(gens, dim: int, max_depth: int,
               device=config.DEFAULT_DEVICE) -> TransitionNoise:
    """Draw one transition's :class:`TransitionNoise`, chain ``c`` from
    ``gens[c]`` (float64, drawn on the CPU and moved to ``device``: a host
    sync a field on the card, counted as ``host_sync.nuts.noise``)."""
    device = config.get_device(device)
    f64 = torch.float64
    nleaf = 2 ** max(max_depth - 1, 0)
    per_chain = [
        (
            torch.randn(dim, generator=g, dtype=f64),
            2.0 * torch.randint(0, 2, (max_depth,), generator=g).to(f64) - 1.0,
            torch.rand(max_depth, nleaf, generator=g, dtype=f64),
            torch.rand(max_depth, generator=g, dtype=f64),
        )
        for g in gens
    ]
    count("host_sync.nuts.noise", len(TransitionNoise._fields))
    return TransitionNoise(*(torch.stack(field).to(device) for field in zip(*per_chain)))


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _trailing_ones(n: int) -> int:
    return _popcount(n ^ (n + 1)) - 1


def _is_turning(rho, v_first, v_last):
    return (torch.sum(rho * v_first, dim=-1) <= 0) | (torch.sum(rho * v_last, dim=-1) <= 0)


class _Subtree(NamedTuple):
    n: torch.Tensor  # (A,) leaves taken
    z: torch.Tensor  # state at the moving end
    r: torch.Tensor
    grad: torch.Tensor
    rho: torch.Tensor  # momentum sum within the subtree
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    log_sum_w: torch.Tensor
    sum_accept: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor


def _build_subtree(vg, u_leaf, z0, r0, grad0, direction, num_leaves, energy0,
                   step_size, inv_mass, max_depth):
    """Take up to ``num_leaves`` leapfrog steps from ``(z0, r0)`` in every
    row, progressively sampling a proposal and checking U-turns at every
    power-of-two boundary.  A row stops at its own U-turn or divergence.

    :param u_leaf: (A, >= num_leaves) uniforms of this depth, one per leaf
    """
    A, dim = z0.shape
    dtype, device = z0.dtype, z0.device
    signed_step = direction * step_size
    zeros = torch.zeros(A, dtype=dtype, device=device)
    z, r, grad = z0.clone(), r0.clone(), grad0.clone()
    rho = torch.zeros_like(r0)
    z_prop, grad_prop = z0.clone(), grad0.clone()
    logp_prop = torch.full_like(zeros, -torch.inf)
    log_sum_w = torch.full_like(zeros, -torch.inf)
    sum_accept = zeros.clone()
    n_done = torch.zeros(A, dtype=torch.int64, device=device)
    turning = torch.zeros(A, dtype=torch.bool, device=device)
    diverging = torch.zeros(A, dtype=torch.bool, device=device)
    # checkpoint buffers, one slot per tree level
    v_ckpt = torch.zeros(A, max_depth, dim, dtype=dtype, device=device)
    rho_before_ckpt = torch.zeros_like(v_ckpt)

    for n in range(num_leaves):
        count("host_sync.nuts.leaf")
        idx = torch.nonzero(~turning & ~diverging)[:, 0]
        if idx.numel() == 0:
            break
        im = inv_mass[idx]
        zn, rn, logp, gn = leapfrog(vg, z[idx], r[idx], grad[idx], signed_step[idx], im)
        energy = -logp + kinetic(rn, im)
        energy = torch.where(torch.isfinite(energy), energy, torch.inf)
        delta = energy - energy0[idx]
        log_w = -delta

        # progressive multinomial sampling within the subtree
        lsw = torch.logaddexp(log_sum_w[idx], log_w)
        take = torch.log(u_leaf[idx, n]) < (log_w - lsw)
        z_prop[idx] = torch.where(take[:, None], zn, z_prop[idx])
        logp_prop[idx] = torch.where(take, logp, logp_prop[idx])
        grad_prop[idx] = torch.where(take[:, None], gn, grad_prop[idx])
        log_sum_w[idx] = lsw
        sum_accept[idx] += torch.clamp(torch.exp(-delta), max=1.0)

        rho_before = rho[idx]
        rho_n = rho_before + rn
        v = mass_velocity(im, rn)
        if n % 2 == 0:
            # store a checkpoint at even leaves: slot = popcount(n)
            slot = _popcount(n)
            v_ckpt[idx, slot] = v
            rho_before_ckpt[idx, slot] = rho_before
        else:
            # check all completed power-of-two intervals at odd leaves
            idx_min = _popcount(n + 1) - 1
            turn = torch.zeros_like(take)
            for i in range(idx_min, idx_min + _trailing_ones(n)):
                turn |= _is_turning(rho_n - rho_before_ckpt[idx, i], v_ckpt[idx, i], v)
            turning[idx] = turn
        diverging[idx] = delta > MAX_DELTA_ENERGY
        z[idx], r[idx], grad[idx], rho[idx] = zn, rn, gn, rho_n
        n_done[idx] += 1

    return _Subtree(
        n=n_done, z=z, r=r, grad=grad, rho=rho, z_prop=z_prop, logp_prop=logp_prop,
        grad_prop=grad_prop, log_sum_w=log_sum_w, sum_accept=sum_accept,
        turning=turning, diverging=diverging,
    )


class NUTSStats(NamedTuple):
    accept_prob: torch.Tensor
    num_steps: torch.Tensor
    depth: torch.Tensor
    diverging: torch.Tensor
    energy: torch.Tensor


def nuts_transition(vg: Callable, z, logp, grad, noise: TransitionNoise, step_size,
                    inv_mass, max_depth: int = 10):
    """One NUTS update of every chain; returns ``(z', logp', grad', NUTSStats)``.

    :param vg: ``(A, dim) -> (logp (A,), grad (A, dim))`` on detached
        tensors, rows independent; called with the rows still active
    :param z, grad: (C, dim); :param logp, step_size: (C,)
    :param inv_mass: (C, dim) or (C, dim, dim)
    """
    C = z.shape[0]
    dtype, device = z.dtype, z.device
    r0 = draw_momentum(noise.xi, inv_mass)
    energy0 = -logp + kinetic(r0, inv_mass)

    z_fwd, r_fwd, grad_fwd = z.clone(), r0.clone(), grad.clone()
    z_bwd, r_bwd, grad_bwd = z.clone(), r0.clone(), grad.clone()
    z_prop, logp_prop, grad_prop = z.clone(), logp.clone(), grad.clone()
    log_sum_w = torch.zeros(C, dtype=dtype, device=device)
    rho = r0.clone()
    turning = torch.zeros(C, dtype=torch.bool, device=device)
    diverging = torch.zeros(C, dtype=torch.bool, device=device)
    sum_accept = torch.zeros(C, dtype=dtype, device=device)
    num_steps = torch.zeros(C, dtype=torch.int64, device=device)
    depth = torch.zeros(C, dtype=torch.int64, device=device)

    for d in range(max_depth):
        count("host_sync.nuts.depth")
        act = torch.nonzero(~turning & ~diverging)[:, 0]
        if act.numel() == 0:
            break
        direction = noise.dirs[act, d]
        fwd = direction > 0
        fcol = fwd[:, None]
        im = inv_mass[act]
        with span("gpcsd.nuts.subtree", depth=d, rows=act.numel()):
            sub = _build_subtree(
                vg, noise.u_leaf[act, d],
                torch.where(fcol, z_fwd[act], z_bwd[act]),
                torch.where(fcol, r_fwd[act], r_bwd[act]),
                torch.where(fcol, grad_fwd[act], grad_bwd[act]),
                direction, 2 ** d, energy0[act], step_size[act], im, max_depth,
            )
        num_steps[act] += sub.n
        sum_accept[act] += sub.sum_accept
        bad = sub.turning | sub.diverging

        # biased progressive sampling across doublings
        lsw = log_sum_w[act]
        take = ~bad & (torch.log(noise.u_doubling[act, d]) < (sub.log_sum_w - lsw))
        z_prop[act] = torch.where(take[:, None], sub.z_prop, z_prop[act])
        logp_prop[act] = torch.where(take, sub.logp_prop, logp_prop[act])
        grad_prop[act] = torch.where(take[:, None], sub.grad_prop, grad_prop[act])
        log_sum_w[act] = torch.where(bad, lsw, torch.logaddexp(lsw, sub.log_sum_w))

        # extend the trajectory ends and re-check the full-tree U-turn
        ext_f, ext_b = (fwd & ~bad)[:, None], (~fwd & ~bad)[:, None]
        z_fwd[act] = torch.where(ext_f, sub.z, z_fwd[act])
        r_fwd[act] = torch.where(ext_f, sub.r, r_fwd[act])
        grad_fwd[act] = torch.where(ext_f, sub.grad, grad_fwd[act])
        z_bwd[act] = torch.where(ext_b, sub.z, z_bwd[act])
        r_bwd[act] = torch.where(ext_b, sub.r, r_bwd[act])
        grad_bwd[act] = torch.where(ext_b, sub.grad, grad_bwd[act])
        rho_new = torch.where(bad[:, None], rho[act], rho[act] + sub.rho)
        rho[act] = rho_new
        turning_full = _is_turning(
            rho_new, mass_velocity(im, r_bwd[act]), mass_velocity(im, r_fwd[act])
        )
        turning[act] = bad | turning_full
        diverging[act] = sub.diverging
        depth[act] += 1

    stats = NUTSStats(
        accept_prob=sum_accept / torch.clamp(num_steps, min=1).to(dtype),
        num_steps=num_steps,
        depth=depth,
        diverging=diverging,
        energy=-logp_prop,
    )
    return z_prop, logp_prop, grad_prop, stats


class NUTSResult(NamedTuple):
    samples: torch.Tensor  # (C, num_samples, dim); (num_samples, dim) from nuts_run
    logp: torch.Tensor
    accept_prob: torch.Tensor
    num_steps: torch.Tensor
    diverging: torch.Tensor
    step_size: torch.Tensor
    inv_mass: torch.Tensor


def _pool_welford_chains(wf):
    """Combine per-chain Welford states into one pooled estimate, broadcast
    back to every chain (parallel-Welford merge; ``m2`` is divided by the
    chain count so per-chain counts keep their scale and the implied
    variance equals the pooled variance).  Chains have equal counts.
    Handles both the diagonal state ((C, dim) ``m2``) and the dense one
    ((C, dim, dim): cross terms pooled with outer products)."""
    mean, m2, cnt = wf.mean, wf.m2, wf.count
    nchains = mean.shape[0]
    mean_tot = mean.mean(dim=0)
    d = mean - mean_tot[None]
    w = cnt.to(mean.dtype)
    if m2.ndim == 3:  # dense
        between = torch.einsum("c,ci,cj->ij", w, d, d)
    else:
        between = torch.sum(torch.square(d) * w[:, None], dim=0)
    m2_each = (m2.sum(dim=0) + between) / nchains
    return type(wf)(
        mean=mean_tot.expand(mean.shape).clone(),
        m2=m2_each.expand(m2.shape).clone(),
        count=cnt,
    )


def _map_leaves(fn, tree):
    """``fn`` on every tensor of a tuple / NamedTuple tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, t) for t in tree))
    return tuple(_map_leaves(fn, t) for t in tree)


def stepsize_floor_guard(carry, nchains, at=-1, floor=1e-6):
    """Replace collapsed-step chains with the healthiest chain's full state.

    A chain whose dual-averaged step size sits orders of magnitude below
    the others is trapped (whitening mismatch, a hostile start), and dual
    averaging is in equilibrium AT that step: it never recovers on its
    own, it only burns the run's budget.  The repair is a restart from a
    healthy chain's complete state (position, logp/grad, dual averaging,
    Welford, metric), valid because warmup draws carry no
    posterior-correctness obligation.

    :param carry: ``(z, logp, grad, da, wf, inv_mass)``; every tensor in it
        has the chain axis first
    :return: ``carry`` itself when no chain is sick (a healthy run never
        triggers the guard), else a repaired copy
    """
    count("host_sync.nuts.guard")
    steps = np.exp(carry[3].log_step_avg.detach().cpu().numpy())
    # reference = median of the plausibly-healthy chains (within 1e3x of
    # the best), so a MAJORITY of collapsed chains cannot drag the median
    # down to their own scale and mask themselves
    healthy = steps[steps >= 1e-3 * steps.max()]
    med = float(np.median(healthy))
    sick = np.where(steps < floor * med)[0]
    if sick.size == 0 or sick.size >= nchains:
        return carry
    donor = int(np.argmax(steps))
    warnings.warn(
        "nuts_chains: step-size floor guard at transition %d: chain(s) %s "
        "collapsed to %s (healthy median %.3g); reinitializing from chain %d "
        "(step %.3g)"
        % (at, sick.tolist(), steps[sick].tolist(), med, donor, float(steps[donor]))
    )

    def rep(x):
        if x.ndim >= 1 and x.shape[0] == nchains:
            row = x[donor].clone()
            x = x.clone()
            count("host_sync.nuts.guard")
            x[torch.as_tensor(sick, device=x.device)] = row
        return x

    return _map_leaves(rep, carry)


def nuts_chains(
    log_prob: Callable,
    u0s,
    gens,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_depth: int = 10,
    target_accept: float = 0.8,
    dense_mass: bool = False,
    pool_warmup: bool = False,
    callback=None,
    state_path=None,
    save_every: int = 1,
    init_step_size: float = 1.0,
    adapt_mass: bool = True,
) -> NUTSResult:
    """Multi-chain NUTS with Stan-style warmup, chains batched in lock-step.
    At 25%/50%/75% of warmup any chain whose dual-averaged step size has
    collapsed is reinitialized (:func:`stepsize_floor_guard`).

    :param log_prob: ``(C, dim) -> (C,)`` unnormalized posterior
        log-density on tensors, rows independent and differentiable
    :param u0s: (nchains, dim) starting points, on the device to run on
    :param gens: one ``torch.Generator`` per chain (:func:`chain_generators`)
    :param dense_mass: adapt a full-covariance metric (Stan's dense_e)
        instead of the diagonal one; ``inv_mass`` is then a per-chain
        (dim, dim) posterior-covariance estimate
    :param pool_warmup: share the Welford mass-matrix statistics across
        all chains every :data:`POOL_EVERY` warmup transitions, so each
        chain's metric is estimated from nchains times more draws.
        Step-size adaptation stays per chain.
    :param callback: ``callback(i, carry)`` after transition ``i``, with
        ``carry = (z, logp, grad, da, wf, inv_mass)``
    :param state_path: checkpoint file stem
        (:func:`gpcsd_tpu_torch.io.checkpoint.save_sampler_state`).  When a
        saved state is there the run continues from it, with the saved
        generator states in place of those of ``gens`` (which are set to
        them); it must come from a run with the same arguments.  The state
        holds the next transition's index, ``carry``, the result buffers and
        every generator's state, and is written BEFORE ``callback`` runs, so
        a callback that raises at a saved transition loses nothing.
    :param save_every: save after every this many transitions (and after
        the last)
    :param init_step_size: where the initial step-size search starts
        (:func:`~gpcsd_tpu_torch.infer.hmc.find_reasonable_step_size`)
    :param adapt_mass: adapt the metric in warmup's slow windows; with
        False the metric stays the identity and only the step size adapts
    """
    u0s = u0s.detach()
    nchains, dim = u0s.shape
    dtype, device = u0s.dtype, u0s.device
    if len(gens) != nchains:
        raise ValueError(f"{len(gens)} generators for {nchains} chains")

    def vg(z):
        global evaluations
        evaluations += z.shape[0]
        return value_and_grad_rows(log_prob, z)

    if dense_mass:
        wf_init = lambda: dense_welford_init(dim, (nchains,), dtype, device)  # noqa: E731
        wf_update, wf_estimate = dense_welford_update, dense_welford_cov
        inv_mass = torch.eye(dim, dtype=dtype, device=device).expand(nchains, dim, dim).clone()
    else:
        wf_init = lambda: welford_init(dim, (nchains,), dtype, device)  # noqa: E731
        wf_update, wf_estimate = welford_update, welford_variance
        inv_mass = torch.ones(nchains, dim, dtype=dtype, device=device)

    slow, window_end = stan_warmup_schedule(num_warmup)
    guard_at = set()
    if nchains >= 2 and num_warmup > 0:
        guard_at = {math.ceil(f * num_warmup) - 1 for f in (0.25, 0.5, 0.75)}
    total = num_warmup + num_samples
    run_id = {"nchains": nchains, "dim": dim, "num_warmup": num_warmup,
              "num_samples": num_samples, "max_depth": max_depth,
              "target_accept": float(target_accept), "dense_mass": bool(dense_mass),
              "pool_warmup": bool(pool_warmup), "init_step_size": float(init_step_size),
              "adapt_mass": bool(adapt_mass)}

    if state_path is not None and sampler_state_exists(state_path):
        st = load_sampler_state(state_path, device)
        if st["run_id"] != run_id:
            raise ValueError(
                f"the sampler state at {state_path} is of another run: {st['run_id']} "
                f"against {run_id}"
            )
        start = st["next"]
        z, logp, grad, da, wf, inv_mass = st["carry"]
        samples, logps, accept, steps, divs = st["buffers"]
        for g, gs in zip(gens, st["generators"]):
            g.set_state(torch.from_numpy(gs))
    else:
        start = 0
        xi0 = torch.stack([torch.randn(dim, generator=g, dtype=torch.float64) for g in gens])
        count("host_sync.nuts.noise")
        step0 = find_reasonable_step_size(vg, u0s, xi0.to(device=device, dtype=dtype), inv_mass,
                                          init=init_step_size)
        z = u0s.clone()
        logp, grad = vg(z)
        da, wf = da_init(step0), wf_init()
        samples = torch.empty(nchains, num_samples, dim, dtype=dtype, device=device)
        logps = torch.empty(nchains, num_samples, dtype=dtype, device=device)
        accept = torch.empty_like(logps)
        steps = torch.empty(nchains, num_samples, dtype=torch.int64, device=device)
        divs = torch.empty(nchains, num_samples, dtype=torch.bool, device=device)

    for i in range(start, total):
        warm = i < num_warmup
        with span("gpcsd.nuts.transition", i=i, warm=warm):
            step_size = torch.exp(da.log_step if warm else da.log_step_avg)
            noise = draw_noise(gens, dim, max_depth, device)
            z, logp, grad, stats = nuts_transition(
                vg, z, logp, grad, noise, step_size, inv_mass, max_depth=max_depth
            )
            if warm:
                da = da_update(da, stats.accept_prob, target=target_accept)
                if slow[i] and adapt_mass:
                    wf = wf_update(wf, z)
                if window_end[i] and adapt_mass:
                    inv_mass = wf_estimate(wf)
                    da = da_init(torch.exp(da.log_step_avg))
                    wf = wf_init()
                if pool_warmup and adapt_mass and (i + 1) % POOL_EVERY == 0:
                    wf = _pool_welford_chains(wf)
                if i in guard_at:
                    z, logp, grad, da, wf, inv_mass = stepsize_floor_guard(
                        (z, logp, grad, da, wf, inv_mass), nchains, at=i
                    )
            else:
                k = i - num_warmup
                samples[:, k], logps[:, k] = z, logp
                accept[:, k], steps[:, k] = stats.accept_prob, stats.num_steps
                divs[:, k] = stats.diverging
            carry = (z, logp, grad, da, wf, inv_mass)
            if state_path is not None and ((i + 1) % save_every == 0 or i + 1 == total):
                save_sampler_state(
                    {"run_id": run_id, "next": i + 1, "carry": carry,
                     "buffers": (samples, logps, accept, steps, divs),
                     "generators": [g.get_state().numpy() for g in gens]},
                    state_path,
                )
        if callback is not None:
            with span("gpcsd.nuts.callback", i=i):
                callback(i, carry)

    return NUTSResult(
        samples=samples, logp=logps, accept_prob=accept, num_steps=steps, diverging=divs,
        step_size=torch.exp(da.log_step_avg), inv_mass=inv_mass,
    )


def nuts_run(log_prob: Callable, u0, gen, **kw) -> NUTSResult:
    """Single-chain NUTS: :func:`nuts_chains` on one chain, without the
    chain axis.  ``log_prob`` is still the batched ``(C, dim) -> (C,)``."""
    res = nuts_chains(log_prob, u0[None], [gen], **kw)
    return NUTSResult(*(f[0] for f in res))
