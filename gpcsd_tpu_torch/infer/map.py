"""Multi-restart MAP fitting (the reference's only hyperparameter inference).

Counterpart of ``gpcsd_tpu.infer.map`` with ``backend='scipy'``: serial scipy
``L-BFGS-B`` over the log-transformed parameters, as the reference does
(``gpcsd1d.py:130-246``).  Restarts start at prior draws clipped into the
box (:func:`sample_restarts`); the best finite-NLL restart wins.  The
objective and its gradient are evaluated with ``torch.autograd`` on the
device of ``Y``; only float64 numpy vectors cross to scipy.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.optimize
import torch

from ..models.params import ParamSet


class MAPResult(NamedTuple):
    u_best: np.ndarray  # best unconstrained parameter vector
    nll_best: float
    nll_values: np.ndarray  # per-restart NLLs (inf for failed restarts)
    u_all: np.ndarray  # (n_restarts, dim)
    messages: list


def sample_restarts(param_set: ParamSet, gen: np.random.Generator, n_restarts: int) -> np.ndarray:
    """(n_restarts, dim) prior draws packed to u-space and clipped into the
    box (reference draws can start outside the L-BFGS-B bounds)."""
    return np.stack([
        param_set.clip_to_bounds(param_set.pack(param_set.sample(gen))).numpy()
        for _ in range(n_restarts)
    ])


def value_and_grad(fn: Callable, u: np.ndarray, device) -> tuple[float, np.ndarray]:
    """``fn(u)`` and its gradient by autograd, with ``u`` placed on ``device``."""
    ut = torch.tensor(u, dtype=torch.float64, device=device, requires_grad=True)
    f = fn(ut)
    (g,) = torch.autograd.grad(f, ut)
    return float(f.detach()), g.detach().cpu().numpy()


def map_fit(
    neg_log_joint: Callable,
    param_set: ParamSet,
    Y,
    u0s,
    maxiter: int = 1000,
    gtol: float = 1e-5,
    ftol: float = 1e7 * np.finfo(float).eps,
    verbose: bool = False,
) -> MAPResult:
    """Fit by multi-restart MAP, one L-BFGS-B run per starting point.

    :param neg_log_joint: ``(u, Y) -> scalar`` objective on tensors.
    :param u0s: (n_restarts, dim) starting points in u-space, e.g. from
        :func:`sample_restarts`.
    """
    lo, hi = param_set.bounds()

    def fun(u):
        return value_and_grad(lambda ut: neg_log_joint(ut, Y), u, Y.device)

    sbounds = [
        (float(l) if np.isfinite(l) else None, float(h) if np.isfinite(h) else None)
        for l, h in zip(lo, hi)
    ]
    nlls, u_all, messages = [], [], []
    for u0 in np.asarray(u0s, dtype=np.float64):
        opt = scipy.optimize.minimize(
            fun, u0, jac=True, method="L-BFGS-B", bounds=sbounds,
            options={"maxiter": maxiter, "gtol": gtol, "ftol": ftol},
        )
        nlls.append(opt.fun)
        u_all.append(opt.x)
        messages.append(str(opt.message))
    nlls = np.asarray(nlls)
    u_all = np.asarray(u_all)

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
    )
