"""Per-trial time-shift estimation for evoked CSD components, counterpart of
``gpcsd_tpu.models.shifts``.

Parity target: the reference ``auditory_lfp/fit_mean_function.py:299-333``:
for each trial, find per-component time shifts tau maximizing the GP
residual likelihood (whitened by the fitted model's Kronecker eigen
factors) with a Gaussian prior on tau, optimized by L-BFGS.  The reference
fans this out over CPU processes with joblib and the JAX package vmaps its
optimizer over trials; here the trials are the rows of one batched
:func:`gpcsd_tpu_torch.infer.lbfgs.lbfgs_minimize` run, each row carrying
its own trial's LFP as ``row_data``.  The residual's quadratic term is the
quadform kernel's function, one launch per row and evaluation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..infer.lbfgs import lbfgs_minimize
from ..ops.cuda.quadform import quadform
from ..ops.kronlik import KronFactors

#: ``jnp.interp``'s threshold below which a knot interval counts as empty
_DX_EPS = float(np.spacing(np.finfo(np.float64).eps))


class ShiftResult(NamedTuple):
    tau: np.ndarray  # (ntrials, n_seg)
    nll: np.ndarray  # (ntrials,)
    converged: np.ndarray  # (ntrials,)
    n_evals: np.ndarray  # (ntrials,) value-and-gradient evaluations per trial


def shift_component(mu, t, tau):
    """Time-shift one component (nx, nt) by tau via linear interpolation,
    holding the edge values outside [t[0], t[-1]] (the reference uses scipy
    interp1d with fill_value='extrapolate'; edge-hold is the stable
    equivalent).

    Follows ``jnp.interp`` exactly, value and gradient: the interval of
    ``x = t + tau`` is ``clip(searchsorted(t, x, side='right'), 1, nt - 1)``,
    so at a knot the interval to its right is used (at tau = 0 the gradient
    is the right-hand slope), and outside the edges the value is held and
    the gradient is 0.

    :param tau: scalar, or (B,) for B shifted copies
    :return: (nx, nt), or (B, nx, nt)
    """
    t = t.reshape(-1)
    n = t.shape[0]
    x = t + tau[..., None]  # (..., nt)
    i = torch.clamp(torch.searchsorted(t, x.detach(), right=True), 1, n - 1)
    lo_f, hi_f = mu[:, i - 1], mu[:, i]  # (nx, ..., nt)
    dx = t[i] - t[i - 1]
    delta = x - t[i - 1]
    dx0 = torch.abs(dx) <= _DX_EPS
    f = torch.where(dx0, lo_f, lo_f + (delta / torch.where(dx0, 1.0, dx)) * (hi_f - lo_f))
    edge = (mu.shape[0],) + (1,) * x.ndim
    f = torch.where(x < t[0], mu[:, 0].reshape(edge), f)
    f = torch.where(x > t[-1], mu[:, -1].reshape(edge), f)
    return torch.movedim(f, 0, -2)


def shift_nll(tau, lfp_trial, mu_background, mu_components, t, factors: KronFactors,
              prior_mu=0.0, prior_sd=10.0):
    """Negative log-likelihood of one trial's residual under the GP noise
    model, plus the Gaussian shift prior (``fit_mean_function.py:301-311``).

    :param tau: (n_seg,), or (B, n_seg) for B trials at once
    :param lfp_trial: (nx, nt), or (B, nx, nt)
    :return: scalar, or (B,); the quadratic term is one :func:`quadform`
        call (one kernel launch on the card) per trial
    """
    single = tau.ndim == 1
    if single:
        tau, lfp_trial = tau[None], lfp_trial[None]
    mu_new = mu_background
    for i in range(mu_components.shape[0]):
        mu_new = mu_new + shift_component(mu_components[i], t, tau[:, i])
    resid = (lfp_trial - mu_new).contiguous()
    qs, qt = factors.qs.contiguous(), factors.qt.contiguous()
    dinv = (1.0 / factors.d).contiguous()
    quad = 0.5 * torch.stack([quadform(qs, qt, dinv, resid[b : b + 1])
                              for b in range(resid.shape[0])])
    prior = 0.5 * torch.sum(torch.square((tau - prior_mu) / prior_sd), dim=-1)
    out = quad + prior
    return out[0] if single else out


def estimate_shifts(
    lfp_trials,
    mu_background,
    mu_components,
    t,
    factors: KronFactors,
    prior_mu=0.0,
    prior_sd=10.0,
    maxiter=200,
    device=config.DEFAULT_DEVICE,
) -> ShiftResult:
    """Fit per-trial shifts for all trials in one batched L-BFGS run on
    ``device``, each trial a row with its LFP as the row's data.

    :param lfp_trials: (nx, nt, ntrials)
    :param mu_background: (nx, nt) non-shifted background component
    :param mu_components: (n_seg, nx, nt) shiftable components
    :param factors: Kronecker eigen factors of the fitted noise model
        (``model._fns().build_factors(model._theta())``)
    :return: ShiftResult with (ntrials, n_seg) shifts in ms, as numpy
    """
    dev = config.get_device(device)
    Y = torch.movedim(config.on_device(lfp_trials, dev), 2, 0).contiguous()  # (ntrials, nx, nt)
    mu_background = config.on_device(mu_background, dev)
    mu_components = config.on_device(mu_components, dev)
    t = config.on_device(t, dev).reshape(-1)
    factors = KronFactors(*(torch.as_tensor(f).detach().to(dev) for f in factors))
    n_seg = mu_components.shape[0]

    def nll(tau, y):
        return shift_nll(tau, y, mu_background, mu_components, t, factors, prior_mu, prior_sd)

    res = lbfgs_minimize(nll, torch.zeros((Y.shape[0], n_seg), dtype=Y.dtype, device=dev),
                         max_iter=maxiter, row_data=Y)
    return ShiftResult(
        tau=res.u.cpu().numpy(), nll=res.f.cpu().numpy(),
        converged=res.converged.cpu().numpy(), n_evals=res.n_evals,
    )
