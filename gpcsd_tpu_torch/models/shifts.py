"""Per-trial time-shift estimation for evoked CSD components, counterpart of
``gpcsd_tpu.models.shifts``.

Parity target: the reference ``auditory_lfp/fit_mean_function.py:299-333``:
for each trial, find per-component time shifts tau maximizing the GP
residual likelihood (whitened by the fitted model's Kronecker eigen
factors) with a Gaussian prior on tau, optimized by L-BFGS.  The reference
fans this out over CPU processes with joblib and the JAX package vmaps its
optimizer over trials; here the trials are the rows of one batched
:func:`gpcsd_tpu_torch.infer.lbfgs.lbfgs_minimize` run, each row carrying
its own trial's LFP as ``row_data``.  The rows share the noise model's
factors, so the residuals' quadratic terms of one batched evaluation are
one :func:`~gpcsd_tpu_torch.ops.cuda.quadform.quadform_rows` call: one
kernel launch for all the rows it evaluates, with an output per row.  The
segments (tens on real data) are shifted together by
:func:`shift_components`, so an evaluation's host work does not grow with
their number.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..infer.lbfgs import lbfgs_minimize
from ..ops.cuda.quadform import quadform_rows
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
    return shift_components(mu[None], t, tau[..., None])[..., 0, :, :]


def shift_components(mu_components, t, tau):
    """:func:`shift_component` of each of S components by its own shift, in
    one pass: the same arithmetic, in a number of tensor operations that
    does not grow with S (the shift stage's segments number tens).

    :param mu_components: (S, nx, nt)
    :param tau: (S,), or (B, S) for B shifted copies
    :return: (S, nx, nt), or (B, S, nx, nt)
    """
    t = t.reshape(-1)
    n = t.shape[0]
    x = t + tau[..., None]  # (..., S, nt)
    i = torch.clamp(torch.searchsorted(t, x.detach(), right=True), 1, n - 1)
    dx = t[i] - t[i - 1]
    dx0 = torch.abs(dx) <= _DX_EPS
    w = torch.where(dx0, 0.0, (x - t[i - 1]) / torch.where(dx0, 1.0, dx))
    # outside [t[0], t[-1]] both knots are the edge's: the value is held
    # exactly and the gradient is 0
    lo = torch.where(x > t[-1], n - 1, i - 1)
    hi = torch.where(x < t[0], 0, i)
    shape = (*i.shape[:-1], mu_components.shape[-2], n)  # (..., S, nx, nt)
    mu = mu_components.expand(shape)
    lo_f = torch.gather(mu, -1, lo.unsqueeze(-2).expand(shape))
    hi_f = torch.gather(mu, -1, hi.unsqueeze(-2).expand(shape))
    return lo_f + w.unsqueeze(-2) * (hi_f - lo_f)


def shift_nll(tau, lfp_trial, mu_background, mu_components, t, factors: KronFactors,
              prior_mu=0.0, prior_sd=10.0):
    """Negative log-likelihood of one trial's residual under the GP noise
    model, plus the Gaussian shift prior (``fit_mean_function.py:301-311``).

    :param tau: (n_seg,), or (B, n_seg) for B trials at once
    :param lfp_trial: (nx, nt), or (B, nx, nt)
    :return: scalar, or (B,); the B quadratic terms are one
        :func:`quadform_rows` call (one kernel launch on the card)
    """
    single = tau.ndim == 1
    if single:
        tau, lfp_trial = tau[None], lfp_trial[None]
    mu_new = mu_background + torch.sum(shift_components(mu_components, t, tau), dim=-3)
    resid = (lfp_trial - mu_new).contiguous()
    qs, qt = factors.qs.contiguous(), factors.qt.contiguous()
    dinv = (1.0 / factors.d).contiguous()
    quad = 0.5 * quadform_rows(qs, qt, dinv, resid)
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
