"""Sharded inference: trial-parallel likelihood, chain-parallel NUTS/MAP/SMC.

Counterpart of ``gpcsd_tpu.parallel.sharded``, SPMD over the ranks of a
``(chain, trial)`` mesh (:func:`gpcsd_tpu_torch.parallel.mesh.make_mesh`):

- Y ``(ntrials, nx, nt)`` is split over ``trial``
  (:func:`~gpcsd_tpu_torch.parallel.mesh.shard_trials`); each rank computes
  the quadratic term of its block through the quadform kernel, and one
  all-reduce over the ``trial`` group sums it per likelihood evaluation;
- chains, restarts and particle likelihoods are split over ``chain``, each
  rank running its block batched, and the results are joined with an
  all-gather over the ``chain`` group;
- the eigendecompositions are replicated: Ks (nx^2) and Kt (nt^2) are
  small, and every rank of a ``trial`` group factors the same ``u``.

Every rank gets the fully gathered result.  All ranks of a ``trial`` group
see bit-identical reduced values and gradients, so the host-side decisions
of NUTS's trees, L-BFGS's line searches and SMC's ladder agree without
further communication.

Each driver's ``init_overrides`` pins constrained parameter values in its
prior starts, as ``fixed=`` of
:func:`~gpcsd_tpu_torch.infer.map.sample_restarts` does.  Not carried over:
``make_trial_sharded_log_prob_aux`` and ``warm_basis`` (the JAX package's
warm-started eigenbasis, a TPU eigensolver workaround; the port threads
none).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..infer.advi import advi_fit
from ..infer.lbfgs import lbfgs_minimize
from ..infer.map import sample_restarts
from ..infer.nuts import NUTSResult, chain_generators, nuts_chains
from ..infer.smc import _eval_rows, smc_run
from ..models.core import ModelFns
from ..models.inference_api import prior_starts, stream_generator
from ..ops import kronlik
from .mesh import MESH_DIMS, in_mesh, rank_device, shard_trials


class _ReplicatedInput(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over ``group``.

    Applied to ``u``, the input every rank of the group holds, so the
    gradient each rank gets is the sum of all ranks' local gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOverGroup(torch.autograd.Function):
    """All-reduce SUM forward; identity backward.

    ``torch.distributed.nn.functional.all_reduce`` would all-reduce the
    cotangent as well: with every rank seeding 1, each rank would get the
    group size times its own local gradient, not the sum of the ranks'."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _axis_size(mesh, name):
    return mesh.shape[MESH_DIMS.index(name)]


def _chain_block(mesh, n):
    """The rows ``[lo, hi)`` of ``n`` (a multiple of the chain size) that
    this rank's chain index runs."""
    per = n // _axis_size(mesh, "chain")
    lo = mesh.get_local_rank("chain") * per
    return lo, lo + per


def _gather_chain(mesh, x):
    """Concatenate ``x`` of every rank of this rank's ``chain`` group along
    the first axis, in chain order."""
    group = mesh.get_group("chain")
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def make_trial_sharded_log_prob(fns: ModelFns, ntrials_total: int, mesh):
    """``(u, Y_local) -> log posterior``, the trial terms summed over the
    mesh's ``trial`` group.

    Maps ``u`` ``(C, dim)`` to ``(C,)`` with independent rows (or ``(dim,)``
    to a scalar), as ``fns.log_prob`` does, and is differentiable: every
    rank gets the full value and the full gradient.  ``Y_local`` is this
    rank's block (:func:`~gpcsd_tpu_torch.parallel.mesh.shard_trials`);
    zero-padded trials add nothing to the quadratic term, and the
    log-determinant counts ``ntrials_total`` trials.

    The replicated terms (log-determinant, prior) are divided by the group
    size and go through the same all-reduce as the local quadratic term.
    The gradient takes two collectives: the all-reduce of the ``(C,)``
    values forward and of the ``(C, dim)`` cotangent of ``u`` backward.
    """
    group = mesh.get_group("trial")
    nrep = dist.get_world_size(group)

    def log_prob(u, Y_local):
        u = _ReplicatedInput.apply(u, group)
        fac = fns.build_factors(fns.param_set.unpack(u))
        quad_local = kronlik.quad_term(fac, Y_local)
        logdet = ntrials_total * (torch.sum(torch.log(fac.d), dim=(-2, -1)) + fac.logdet_offset)
        # with one trial rank this is fns.log_prob's arithmetic, bit for bit
        local = -0.5 * (logdet / nrep + quad_local) + fns.log_prior_u(u) / nrep
        return _SumOverGroup.apply(local, group)

    return log_prob


def _setup(fns, Y, mesh):
    """This rank's trial block, the sharded log-prob and the rank's device."""
    ntrials = Y.shape[0]
    return shard_trials(mesh, Y), make_trial_sharded_log_prob(fns, ntrials, mesh), rank_device(mesh)


def nuts_sharded(fns: ModelFns, Y, mesh, seed: int, n_chains: int, num_warmup: int = 500,
                 num_samples: int = 500, max_depth: int = 10, target_accept: float = 0.8,
                 dense_mass: bool = False, init_overrides=None) -> NUTSResult | None:
    """NUTS with chains split over the ``chain`` axis and the trial
    likelihood summed over the ``trial`` axis.

    Chain ``i`` starts at row ``i`` of :func:`prior_starts` and draws from
    ``chain_generators(seed, n_chains)[i]``, whatever the mesh, and
    :func:`~gpcsd_tpu_torch.infer.nuts.nuts_chains` runs each rank's block
    in lock-step.  Its step-size floor guard compares the chains of one
    block.

    :return: a :class:`~gpcsd_tpu_torch.infer.nuts.NUTSResult` with a
        leading ``(n_chains,)`` axis on every rank of the mesh, on the
        rank's device; None on a rank outside the mesh
    """
    if not in_mesh(mesh):
        return None
    if n_chains % _axis_size(mesh, "chain"):
        raise ValueError(
            f"n_chains={n_chains} must divide over {_axis_size(mesh, 'chain')} chain ranks"
        )
    Y_block, log_prob, dev = _setup(fns, Y, mesh)
    lo, hi = _chain_block(mesh, n_chains)
    u0s = torch.as_tensor(prior_starts(fns, seed, n_chains, init_overrides)[lo:hi], device=dev)
    res = nuts_chains(
        lambda u: log_prob(u, Y_block), u0s, chain_generators(seed, n_chains)[lo:hi],
        num_warmup=num_warmup, num_samples=num_samples, max_depth=max_depth,
        target_accept=target_accept, dense_mass=dense_mass,
    )
    return NUTSResult(*(_gather_chain(mesh, f) for f in res))


def advi_sharded(fns: ModelFns, Y, mesh, seed: int, num_steps: int = 2000, n_mc: int = 8,
                 learning_rate: float = 0.02, init_overrides=None):
    """Mean-field ADVI with the trial likelihood summed over the ``trial``
    axis.  The variational state is replicated: every rank runs the same
    Adam trajectory from the same start and draws, those of the model's
    unsharded ``advi`` (:func:`prior_starts` row 0, stream 1).

    :return: an :class:`~gpcsd_tpu_torch.infer.advi.ADVIResult` on the
        rank's device, or None on a rank outside the mesh
    """
    if not in_mesh(mesh):
        return None
    Y_block, log_prob, dev = _setup(fns, Y, mesh)
    u0 = torch.as_tensor(prior_starts(fns, seed, 1, init_overrides)[0], device=dev)
    return advi_fit(lambda u: log_prob(u, Y_block), u0, stream_generator(seed, 1),
                    num_steps=num_steps, n_mc=n_mc, learning_rate=learning_rate)


def smc_sharded(fns: ModelFns, Y, mesh, seed: int, n_particles: int = 1024,
                n_mutation_steps: int = 10, ess_target_frac: float = 0.5, rw_scale: float = 1.0,
                max_stages: int = 100, chunk: int | None = None, init_overrides=None):
    """Tempered SMC with particle likelihoods split over the ``chain`` axis
    and trial terms summed over the ``trial`` axis.

    The particle state and the stages' random numbers are replicated; only
    the likelihood evaluations are split, each rank evaluating its block
    of rows and the blocks re-joined by an all-gather, so the ladder,
    resampling and evidence are those of
    :func:`~gpcsd_tpu_torch.infer.smc.smc_run` on one device.
    ``n_particles`` is padded up to a multiple of the chain size.

    :param chunk: rows per evaluation within a rank's block
    :return: an :class:`~gpcsd_tpu_torch.infer.smc.SMCResult` on the rank's
        device, or None on a rank outside the mesh
    """
    if not in_mesh(mesh):
        return None
    n_chain = _axis_size(mesh, "chain")
    n_particles += -n_particles % n_chain
    Y_block, log_post, dev = _setup(fns, Y, mesh)
    lo, hi = _chain_block(mesh, n_particles)

    def log_like(u):
        return log_post(u, Y_block) - fns.log_prior_u(u)

    def batch_like(ps):
        return _gather_chain(mesh, _eval_rows(log_like, ps[lo:hi], chunk))

    particles0 = torch.as_tensor(prior_starts(fns, seed, n_particles, init_overrides), device=dev)
    return smc_run(fns.log_prior_u, batch_like, particles0, stream_generator(seed, 1),
                   n_mutation_steps=n_mutation_steps, ess_target_frac=ess_target_frac,
                   max_stages=max_stages, rw_scale=rw_scale)


def map_fit_sharded(fns: ModelFns, Y, mesh, seed: int, n_restarts: int, maxiter: int = 1000,
                    gtol: float = 1e-5, ftol: float = 1e7 * np.finfo(float).eps,
                    init_overrides=None):
    """Multi-restart MAP with restarts split over the ``chain`` axis and the
    likelihood summed over the ``trial`` axis: one batched
    :func:`~gpcsd_tpu_torch.infer.lbfgs.lbfgs_minimize` per rank over its
    block, minimizing ``-log_prob`` (which, as in the JAX package, includes
    the log-det-Jacobian).  The starts are ``sample_restarts`` from
    ``numpy.random.default_rng(seed)`` with ``fixed=init_overrides``;
    ``n_restarts`` is padded up to a multiple of the chain size.

    :return: ``(u_all (n_restarts, dim), nll_all (n_restarts,))`` numpy
        arrays, ``inf`` where a restart failed; None on a rank outside the
        mesh
    """
    if not in_mesh(mesh):
        return None
    n_restarts += -n_restarts % _axis_size(mesh, "chain")
    Y_block, log_prob, dev = _setup(fns, Y, mesh)
    lo, hi = _chain_block(mesh, n_restarts)
    u0s = sample_restarts(fns.param_set, np.random.default_rng(seed), n_restarts,
                          fixed=init_overrides)[lo:hi]
    box_lo, box_hi = fns.param_set.bounds()
    res = lbfgs_minimize(lambda u: -log_prob(u, Y_block), torch.as_tensor(u0s, device=dev),
                         lo=box_lo, hi=box_hi, max_iter=maxiter, gtol=gtol, ftol=ftol)
    nll = torch.where(res.failed, torch.inf, res.f)
    return _gather_chain(mesh, res.u).cpu().numpy(), _gather_chain(mesh, nll).cpu().numpy()
