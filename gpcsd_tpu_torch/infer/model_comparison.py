"""Posterior predictive model comparison: WAIC and PSIS-LOO.

Counterpart of ``gpcsd_tpu.infer.model_comparison``: the two standard
fully-Bayesian criteria over the hyperparameter posterior.

- **WAIC** (Watanabe-Akaike information criterion): lppd minus the
  pointwise-variance effective-parameter penalty.
- **PSIS-LOO** (Pareto-smoothed importance-sampling leave-one-out;
  Vehtari, Gelman & Gabry 2017): per-trial leave-one-out predictive
  density with generalized-Pareto smoothing of the importance-weight
  tails and the k-hat reliability diagnostic.

The exchangeable unit is the **trial**: the GPCSD marginal likelihood is a
product of iid trial terms given hyperparameters, so per-trial pointwise
log-likelihoods are the factored quad-form/log-det split that
:func:`gpcsd_tpu_torch.ops.kronlik.loglik` computes, here kept per trial:
the whitening is plain matmuls (as in the JAX package, which calls
``whiten`` and not its Pallas kernel for this), evaluated in chunks of
posterior draws.  Their sum over trials equals ``loglik`` (through the
quadform kernel on the card) plus the constant below.

Unlike the (reference-parity) marginal likelihood, pointwise terms here
INCLUDE the -0.5*nx*nt*log(2*pi) constant: criteria are compared across
models and the constant only cancels when both models see identical data
dimensions, so it is kept explicit.

:func:`pointwise_loglik` runs on the device of ``Y``; the criteria are
numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import logsumexp

from ..ops import kronlik

__all__ = [
    "pointwise_loglik",
    "waic",
    "psis_loo",
    "compare",
]


def pointwise_loglik(fns, us, Y, batch: int = 8):
    """Per-trial log-likelihood for each posterior draw.

    :param fns: :class:`gpcsd_tpu_torch.models.core.ModelFns`.
    :param us: (S, dim) unconstrained hyperparameter draws (numpy or tensor).
    :param Y: (ntrials, nx, nt) trial tensor (``model._Y()`` layout).
    :param batch: draws per batched factorization (bounds the (batch,
        ntrials, nx, nt) whitening intermediate).
    :returns: (S, ntrials) float64 numpy array.
    """
    us = torch.as_tensor(us, dtype=Y.dtype).to(Y.device)
    nx, nt = Y.shape[-2], Y.shape[-1]
    const = -0.5 * nx * nt * float(np.log(2.0 * np.pi))
    out = []
    with torch.no_grad():
        for i in range(0, us.shape[0], batch):
            fac = fns.build_factors(fns.param_set.unpack(us[i:i + batch]))
            # a trial axis after the draws': (batch, ntrials, nx, nt)
            alpha = kronlik.whiten(fac._replace(qs=fac.qs[:, None], qt=fac.qt[:, None]), Y)
            quad = torch.sum(torch.square(alpha) / fac.d[:, None], dim=(-2, -1))
            logdet = torch.sum(torch.log(fac.d), dim=(-2, -1)) + fac.logdet_offset
            out.append(-0.5 * (quad + logdet[:, None]) + const)
    return torch.cat(out).cpu().numpy().astype(np.float64)


def _logmeanexp(a, axis=0):
    return logsumexp(a, axis=axis) - np.log(a.shape[axis])

def waic(ll):
    """WAIC from an (S, n) pointwise log-likelihood matrix.

    Returns dict with ``elpd_waic``, ``p_waic``, ``waic`` (=-2*elpd), and
    the standard error ``se_elpd_waic`` over the pointwise terms.
    """
    ll = np.asarray(ll, dtype=np.float64)
    lppd_i = _logmeanexp(ll, axis=0)
    p_i = ll.var(axis=0, ddof=1)
    elpd_i = lppd_i - p_i
    n = ll.shape[1]
    return {
        "elpd_waic": float(elpd_i.sum()),
        "p_waic": float(p_i.sum()),
        "waic": float(-2.0 * elpd_i.sum()),
        "se_elpd_waic": float(np.sqrt(n * elpd_i.var(ddof=1))),
        "pointwise_elpd": elpd_i,
    }


def _gpdfit(x):
    """Zhang & Stephens (2009) posterior-mean generalized-Pareto fit to
    exceedances ``x`` (ascending, > 0).  Returns (k, sigma) in the
    heavy-tail-positive-k convention (k > 0.7 = unreliable tail).
    Validated against a GPD(k=0.3) sample in tests (k recovered to 0.03)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    prior_bs, prior_k = 3.0, 10.0
    m = 30 + int(np.sqrt(n))
    bs = 1.0 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    bs /= prior_bs * x[int(n / 4 + 0.5) - 1]
    bs += 1.0 / x[-1]
    ks = np.mean(np.log1p(-bs[:, None] * x[None, :]), axis=1)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        logl = n * (np.log(-(bs / ks)) - ks - 1.0)
        w = 1.0 / np.exp(logl - logl[:, None]).sum(axis=1)
    ok = np.isfinite(w) & (w >= 10 * np.finfo(float).eps)
    w, bs = w[ok], bs[ok]
    w /= w.sum()
    b_post = np.sum(bs * w)
    k_post = np.mean(np.log1p(-b_post * x))
    sigma = -k_post / b_post
    # weakly-informative prior regularization toward k=0.5 (arviz/loo)
    k_post = (n * k_post + prior_k * 0.5) / (n + prior_k)
    return float(k_post), float(sigma)


def _gpd_quantile(p, k, sigma):
    return sigma * np.expm1(-k * np.log1p(-p)) / k if k != 0 else -sigma * np.log1p(-p)


def psislw(log_ratios):
    """Pareto-smoothed importance-sampling log-weights.

    :param log_ratios: (S, n) raw importance log-ratios (for LOO:
        ``-pointwise_loglik``).
    :returns: (smoothed normalized log-weights (S, n), k-hat (n,)).
    """
    lr = np.array(log_ratios, dtype=np.float64)
    S, n = lr.shape
    khat = np.empty(n)
    tail_len = int(np.ceil(min(0.2 * S, 3.0 * np.sqrt(S))))
    for i in range(n):
        x = lr[:, i]
        x -= x.max()
        if tail_len < 5:
            khat[i] = np.inf
            continue
        order = np.argsort(x)
        tail_ids = order[-tail_len:]
        cutoff = x[order[-tail_len - 1]]
        exceed = np.exp(x[tail_ids]) - np.exp(cutoff)
        if np.ptp(exceed) <= 0:
            khat[i] = np.inf
            continue
        k, sigma = _gpdfit(np.sort(exceed))
        # non-finite k (e.g. tied exceedances zeroing the quartile divisor)
        # must register as unreliable -- NaN would evade the k > 0.7 flag
        # since NaN comparisons are False
        khat[i] = k if np.isfinite(k) else np.inf
        if np.isfinite(k):
            # replace tail by smoothed GPD quantiles at plotting positions
            probs = (np.arange(1, tail_len + 1) - 0.5) / tail_len
            smoothed = np.log(
                np.exp(cutoff) + np.array(
                    [_gpd_quantile(p, k, sigma) for p in probs]
                )
            )
            # assign in ascending order to the sorted tail positions
            x[tail_ids[np.argsort(x[tail_ids])]] = smoothed
        x = np.minimum(x, 0.0)  # truncate at the max (log-weight 0)
        lr[:, i] = x
    # normalize per column
    lw = lr - logsumexp(lr, axis=0)[None, :]
    return lw, khat


def psis_loo(ll):
    """PSIS-LOO from an (S, n) pointwise log-likelihood matrix.

    Returns dict with ``elpd_loo``, ``p_loo``, ``looic``, standard error,
    and the per-point Pareto ``k`` diagnostic (k > 0.7 flags unreliable
    importance sampling for that trial).
    """
    ll = np.asarray(ll, dtype=np.float64)
    lw, khat = psislw(-ll)
    elpd_i = logsumexp(lw + ll, axis=0)
    lppd_i = _logmeanexp(ll, axis=0)
    n = ll.shape[1]
    return {
        "elpd_loo": float(elpd_i.sum()),
        "p_loo": float((lppd_i - elpd_i).sum()),
        "looic": float(-2.0 * elpd_i.sum()),
        "se_elpd_loo": float(np.sqrt(n * elpd_i.var(ddof=1))),
        "pareto_k": khat,
        "pointwise_elpd": elpd_i,
    }


def compare(results):
    """Rank models by elpd (dict name -> waic()/psis_loo() result dict).

    Returns a list of (name, elpd, d_elpd_vs_best, se_d) sorted best
    first, with the difference SE computed from the paired pointwise
    terms (Vehtari et al. 2017 eq. 24).
    """
    key = "elpd_loo" if "elpd_loo" in next(iter(results.values())) else "elpd_waic"
    names = sorted(results, key=lambda k: -results[k][key])
    best = results[names[0]]["pointwise_elpd"]
    out = []
    for name in names:
        pe = results[name]["pointwise_elpd"]
        d = pe - best
        se = float(np.sqrt(d.size * d.var(ddof=1))) if d.size > 1 else 0.0
        out.append((name, float(results[name][key]), float(d.sum()), se))
    return out
