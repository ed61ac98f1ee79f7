"""Sampler diagnostics: rank-normalized split-R-hat and bulk/tail ESS.

The port's own copy of ``gpcsd_tpu.infer.diagnostics`` (numpy and scipy
only; nothing of the JAX package can be imported where there is no JAX).
Per-chain acceptance and divergences come from NUTS directly; the
cross-chain convergence measures here follow Vehtari, Gelman, Simpson,
Carpenter & Buerkner (2021): rank-normalized split-R-hat (max over the
rank-normalized and folded-rank-normalized transforms), rank-normalized
bulk ESS and quantile-indicator tail ESS, each via Geyer's initial
positive/monotone pair-sum sequence on FFT autocovariances.

Rank normalization matters operationally: the raw-scale Geyer estimator's
pair-sum loop exits at the first negative pair for near-iid draws, flooring
tau at 1 and reporting ESS == chains x samples exactly, which cannot be
told from an estimator ceiling.  The Stan pairing used here starts the
pair sums at (rho_0 + rho_1), so antithetic chains legitimately report
ESS > N, and the tau floor only caps ESS at N log10(N).
"""

from __future__ import annotations

import numpy as np


def split_chains(samples):
    """(nchains, nsamples, ...) -> (2*nchains, nsamples//2, ...)."""
    samples = np.asarray(samples)
    n = samples.shape[1] // 2
    return np.concatenate([samples[:, :n], samples[:, n : 2 * n]], axis=0)


def _rank_normalize(x):
    """Fractional-rank inverse-normal transform of pooled draws.

    ``x`` is (m, n) for one quantity; ranks are computed over ALL draws
    (average rank for ties), mapped through the Blom offset
    ``(r - 3/8) / (S + 1/4)`` and the normal quantile function —
    Vehtari et al. 2021 eq. (14).
    """
    from scipy.stats import norm, rankdata

    x = np.asarray(x, dtype=np.float64)
    r = rankdata(x, method="average", axis=None).reshape(x.shape)
    return norm.ppf((r - 0.375) / (x.size + 0.25))


def _split_rhat(s):
    """Plain split-R-hat on (m, n, dim) (already-transformed) draws."""
    m, n = s.shape[0], s.shape[1]
    chain_mean = s.mean(axis=1)  # (m, dim)
    chain_var = s.var(axis=1, ddof=1)  # (m, dim)
    between = n * chain_mean.var(axis=0, ddof=1)
    within = chain_var.mean(axis=0)
    var_est = (n - 1) / n * within + between / n
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.sqrt(var_est / within)
    return np.where(within == 0, np.inf, r)


def rhat(samples):
    """Rank-normalized split-R-hat per dimension (Vehtari et al. 2021):
    the max of split-R-hat on the rank-normalized draws (bulk) and on the
    rank-normalized folded draws ``|x - median|`` (tails).

    samples: (nchains, nsamples, dim).  Frozen chains (exactly constant
    draws) report inf explicitly — the worst-case non-convergence must
    not round to a finite ratio.
    """
    s = split_chains(samples)
    m, n, dim = s.shape
    out = np.empty(dim)
    for d in range(dim):
        x = s[:, :, d]
        # a frozen chain ties every rank within that chain; detect on the
        # raw draws where constancy is exact
        if np.any(np.all(x == x[:, :1], axis=1)):
            out[d] = np.inf
            continue
        z = _rank_normalize(x)
        fold = _rank_normalize(np.abs(x - np.median(x)))
        out[d] = max(
            float(_split_rhat(z[:, :, None])[0]),
            float(_split_rhat(fold[:, :, None])[0]),
        )
    return out


def _autocov(x):
    """FFT autocovariance per chain; x (n,) -> (n,)."""
    n = x.shape[0]
    x = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real
    return acov / n


def _ess_core(x):
    """ESS of one (already-transformed) quantity; x (m, n) split chains.

    Stan's estimator: cross-chain ρ_t from pooled autocovariances and the
    between-chain variance, Geyer initial positive sequence on pair sums
    ``P_k = ρ_{2k} + ρ_{2k+1}`` (starting at ρ₀+ρ₁ so antithetic chains
    can report τ < 1 → ESS > N), then the initial monotone correction.
    """
    x = np.asarray(x, dtype=np.float64)
    m, n = x.shape
    if n < 4:
        return float(m * n)
    acovs = np.stack([_autocov(x[c]) for c in range(m)])  # (m, n)
    mean_var = acovs[:, 0].mean() * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus <= 0 or not np.isfinite(var_plus):
        return float(m * n)  # constant draws carry no autocorrelation info
    rho = 1.0 - (mean_var - acovs.mean(axis=0)) / var_plus
    pairs = []
    k = 0
    while 2 * k + 1 < n:
        p = rho[2 * k] + rho[2 * k + 1]
        if p < 0:
            break
        pairs.append(p)
        k += 1
    for i in range(1, len(pairs)):  # initial monotone sequence
        pairs[i] = min(pairs[i], pairs[i - 1])
    tau = -1.0 + 2.0 * float(np.sum(pairs)) if pairs else 1.0
    tau = max(tau, 1.0 / np.log10(max(n, 10)))
    return m * n / tau


def _as3d(samples):
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[None]
    return s


def ess_bulk(samples):
    """Rank-normalized bulk ESS per dimension (Vehtari et al. 2021);
    samples (nchains, nsamples, dim).  May legitimately exceed
    chains×samples for antithetic chains."""
    s = split_chains(_as3d(samples))
    m, n, dim = s.shape
    out = np.empty(dim)
    for d in range(dim):
        out[d] = _ess_core(_rank_normalize(s[:, :, d]))
    return out


def ess_tail(samples, probs=(0.05, 0.95)):
    """Tail ESS per dimension: the minimum over ``probs`` of the ESS of
    the quantile-exceedance indicator ``I(x <= Q_p)`` (Vehtari et al.
    2021) — small when chains disagree about the tails even if the bulk
    mixes."""
    s = split_chains(_as3d(samples))
    m, n, dim = s.shape
    out = np.empty(dim)
    for d in range(dim):
        x = s[:, :, d]
        vals = []
        for p in probs:
            q = np.quantile(x, p)
            vals.append(_ess_core((x <= q).astype(np.float64)))
        out[d] = min(vals)
    return out


def ess(samples):
    """Effective sample size per dimension — the rank-normalized bulk
    ESS (the headline mixing metric; ``ess_tail`` covers the tails)."""
    return ess_bulk(samples)


def summarize(samples, names=None):
    """Tabular posterior summary: mean, sd, 5/95%, bulk/tail ESS, R-hat.

    :param samples: (nchains, nsamples, dim)
    :return: dict name -> dict of scalars
    """
    s = _as3d(samples)
    dim = s.shape[-1]
    names = names or [f"p{i}" for i in range(dim)]
    flat = s.reshape(-1, dim)
    r = rhat(s) if s.shape[0] > 1 and s.shape[1] > 3 else np.full(dim, np.nan)
    eb = ess_bulk(s)
    et = ess_tail(s)
    out = {}
    for i, name in enumerate(names):
        out[name] = {
            "mean": float(flat[:, i].mean()),
            "sd": float(flat[:, i].std()),
            "q5": float(np.quantile(flat[:, i], 0.05)),
            "q95": float(np.quantile(flat[:, i], 0.95)),
            "ess": float(eb[i]),
            "ess_tail": float(et[i]),
            "rhat": float(r[i]),
        }
    return out
