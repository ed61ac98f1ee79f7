"""Multi-restart MAP fitting (the reference's only hyperparameter inference).

Counterpart of ``gpcsd_tpu.infer.map``: bounded L-BFGS on the negative
log-joint over the log-transformed parameters, as the reference does
(``gpcsd1d.py:130-246``).  Restarts start at prior draws clipped into the
box (:func:`sample_restarts`); the best finite-NLL restart wins.

Two execution paths:
- ``backend='torch'`` (default, the counterpart of the JAX package's
  ``backend='jax'``): all restarts in one run of the batched optimizer in
  :mod:`gpcsd_tpu_torch.infer.lbfgs`, state and evaluations on the device of
  ``Y``.
- ``backend='scipy'``: serial scipy ``L-BFGS-B``, one run per restart, the
  reference's own optimizer; only float64 numpy vectors cross to scipy.

The objective and its gradient are evaluated with ``torch.autograd`` on the
device of ``Y`` in both.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.optimize
import torch

from ..models.params import ParamSet
from ..utils.profiling import traced_call
from .lbfgs import lbfgs_minimize


class MAPResult(NamedTuple):
    """What :func:`map_fit` returns.  A fit stopped by ``max_wall_seconds``
    returns none: it raises :class:`~gpcsd_tpu_torch.infer.lbfgs.LBFGSTimeBudget`,
    and the call that completes it from ``state_path`` returns the result of
    the uninterrupted fit."""

    u_best: np.ndarray  # best unconstrained parameter vector
    nll_best: float
    nll_values: np.ndarray  # per-restart NLLs (inf for failed restarts)
    u_all: np.ndarray  # (n_restarts, dim)
    messages: list
    #: backend 'torch' only: value-and-gradient evaluations per restart and
    #: the optimizer's host reads of device state (over every call of a
    #: fit resumed from ``state_path``)
    n_evals: np.ndarray | None = None
    n_syncs: int | None = None


def sample_restarts(param_set: ParamSet, gen: np.random.Generator, n_restarts: int,
                    fixed=None) -> np.ndarray:
    """(n_restarts, dim) prior draws packed to u-space and clipped into the
    box (reference draws can start outside the L-BFGS-B bounds).

    :param gen: ``numpy.random.Generator`` the draws come from, one restart
        after another
    :param fixed: dict of constrained values pinned in every restart (the
        JAX package's ``init_overrides``); the other parameters get the
        draws they get without it (:meth:`ParamSet.sample`)
    """
    return np.stack([
        param_set.clip_to_bounds(param_set.pack(param_set.sample(gen, fixed=fixed))).numpy()
        for _ in range(n_restarts)
    ])


def value_and_grad(fn: Callable, u: np.ndarray, device) -> tuple[float, np.ndarray]:
    """``fn(u)`` and its gradient by autograd, with ``u`` placed on ``device``."""
    ut = torch.tensor(u, dtype=torch.float64, device=device, requires_grad=True)
    f = fn(ut)
    (g,) = torch.autograd.grad(f, ut)
    return float(f.detach()), g.detach().cpu().numpy()


@traced_call("gpcsd.map_fit")
def map_fit(
    neg_log_joint: Callable,
    param_set: ParamSet,
    Y,
    u0s,
    backend: str = "torch",
    maxiter: int = 1000,
    gtol: float = 1e-5,
    ftol: float = 1e7 * np.finfo(float).eps,
    verbose: bool = False,
    chunk_iters: int = 4,
    state_path: str | None = None,
    max_wall_seconds: float | None = None,
) -> MAPResult:
    """Fit by multi-restart MAP.

    :param neg_log_joint: ``(u, Y) -> scalar`` objective on tensors, which
        for ``backend='torch'`` also maps ``(B, dim)`` to ``(B,)``.
    :param u0s: (n_restarts, dim) starting points in u-space, e.g. from
        :func:`sample_restarts` (whose ``fixed=`` pins parameters, the JAX
        package's ``init_overrides``).
    :param backend: ``'torch'``: one batched L-BFGS run over all restarts
        on the device of ``Y``; ``'scipy'``: serial L-BFGS-B.
    :param chunk_iters: ``backend='torch'``: iterations between two
        checkpoints at ``state_path``
    :param state_path: ``backend='torch'``: checkpoint file stem of the
        optimizer's state; a later call with the same starts and options
        resumes from it (:func:`~gpcsd_tpu_torch.infer.lbfgs.lbfgs_minimize`)
    :param max_wall_seconds: ``backend='torch'``: raise
        :class:`~gpcsd_tpu_torch.infer.lbfgs.LBFGSTimeBudget` at the first
        checkpoint after this many seconds; rerun to continue.  Requires
        ``state_path``.
    """
    lo, hi = param_set.bounds()
    u0s = np.asarray(u0s, dtype=np.float64)
    n_evals = n_syncs = None

    if backend == "torch":
        res = lbfgs_minimize(
            lambda u: neg_log_joint(u, Y),
            torch.tensor(u0s, dtype=torch.float64, device=Y.device),
            lo=lo, hi=hi, max_iter=maxiter, gtol=gtol, ftol=ftol,
            chunk_iters=chunk_iters, state_path=state_path, max_wall_seconds=max_wall_seconds,
        )
        nlls = np.where(res.failed.cpu().numpy(), np.inf, res.f.cpu().numpy())
        u_all = res.u.cpu().numpy()
        messages = [
            f"converged={bool(c)} iters={int(n)}"
            for c, n in zip(res.converged.cpu().numpy(), res.n_iter.cpu().numpy())
        ]
        n_evals, n_syncs = res.n_evals, res.n_syncs
    elif backend == "scipy":
        if state_path is not None or max_wall_seconds is not None:
            raise ValueError("state_path and max_wall_seconds need backend='torch'")

        def fun(u):
            return value_and_grad(lambda ut: neg_log_joint(ut, Y), u, Y.device)

        sbounds = [
            (float(l) if np.isfinite(l) else None, float(h) if np.isfinite(h) else None)
            for l, h in zip(lo, hi)
        ]
        nlls, u_all, messages = [], [], []
        for u0 in u0s:
            opt = scipy.optimize.minimize(
                fun, u0, jac=True, method="L-BFGS-B", bounds=sbounds,
                options={"maxiter": maxiter, "gtol": gtol, "ftol": ftol},
            )
            nlls.append(opt.fun)
            u_all.append(opt.x)
            messages.append(str(opt.message))
        nlls = np.asarray(nlls)
        u_all = np.asarray(u_all)
    else:
        raise ValueError(f"unknown backend {backend!r}")

    finite = np.isfinite(nlls)
    if not finite.any():
        raise RuntimeError("problem with optimization! (all restarts failed)")
    best = int(np.flatnonzero(finite)[np.argmin(nlls[finite])])
    if verbose:
        print("Neg log lik values across different initializations:")
        print(nlls)
        print("Best restart message:", messages[best])
    return MAPResult(
        u_best=u_all[best],
        nll_best=float(nlls[best]),
        nll_values=nlls,
        u_all=u_all,
        messages=messages,
        n_evals=n_evals,
        n_syncs=n_syncs,
    )
