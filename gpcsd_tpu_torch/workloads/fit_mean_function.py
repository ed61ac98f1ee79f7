"""Evoked-response mean + per-trial time-shift pipeline (reference Figures
4-5), twin of ``workloads/fit_mean_function.py`` on the PyTorch port,
surrogate mode.

Parity target: the reference ``auditory_lfp/fit_mean_function.py``:

1. evoked (trial-mean) LFP -> GPCSD posterior mean CSD on a dense grid;
2. kCSD estimate of the evoked response for comparison, with the
   reference's cross-validation grid (``:113-115``);
3. watershed segmentation of the evoked CSD into source/sink components
   (:mod:`gpcsd_tpu_torch.utils.segmentation`);
4. forward-model each component back to LFP space;
5. per-trial time-shift estimation for each component by maximizing the
   GP residual likelihood with a Gaussian shift prior, every trial a row of
   one batched L-BFGS run (:func:`gpcsd_tpu_torch.models.shifts.estimate_shifts`);
6. shift correlation matrix with Fisher-z p-values (``:374-400``).

Two modes: :func:`run_real` reads the reference's auditory text files
(and restores the stage-1 ``gpcsd_model_<probe>.pkl`` pickles of the
baseline workload when ``stage1_dir`` has them); :func:`run` builds a
surrogate with KNOWN injected per-trial shifts, so the pipeline doubles as
a correctness check (estimated shifts must correlate with the truth, and
GPCSD must beat kCSD on evoked recovery).  With ``results_dir`` set,
:func:`run` draws the JAX workload's figure
(:func:`gpcsd_tpu_torch.workloads.figures.fit_mean_function_figure`) where
matplotlib imports; :func:`run_real` draws none, as in the JAX workload.

Run: ``python -m gpcsd_tpu_torch.workloads.fit_mean_function [--data-dir PATH
[--stage1-dir PATH]] [--quick] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import config
from ..io.loaders import load_auditory_probe
from ..models.gpcsd1d import GPCSD1D
from ..models.shifts import estimate_shifts
from ..ops.forward import fwd_model_1d
from ..utils.segmentation import segment_csd
from . import figures
from .auditory_lfp import A, B, NX, fit_probe
from .common import report, stage


def _template_components(z, t):
    """Two dipole components with distinct latencies (evoked templates)."""
    z = np.asarray(z).reshape(-1, 1)
    t = np.asarray(t).reshape(1, -1)
    c1 = np.exp(-((z - 600) ** 2) / (2 * 180**2)) * np.exp(-((t - 20) ** 2) / (2 * 4**2))
    c1 -= np.exp(-((z - 1100) ** 2) / (2 * 180**2)) * np.exp(-((t - 20) ** 2) / (2 * 4**2))
    c2 = -np.exp(-((z - 1600) ** 2) / (2 * 160**2)) * np.exp(-((t - 35) ** 2) / (2 * 5**2))
    c2 += np.exp(-((z - 2000) ** 2) / (2 * 160**2)) * np.exp(-((t - 35) ** 2) / (2 * 5**2))
    return [c1, c2]


def _kcsd_evoked(x, lfp_evoked, R, z):
    """kCSD estimate of the evoked response (reference ``:113-115``): CV
    over the reference grids (Rs 100..800 x 15, lambdas 10^1..10^-15 x 25),
    interpolated onto the dense prediction grid ``z``."""
    from scipy.interpolate import interp1d

    from ..models.kcsd import KCSD1D

    k = KCSD1D(np.asarray(x).reshape(-1, 1), np.asarray(lfp_evoked),
               gdx=float(z[1] - z[0]), h=float(R))
    k.cross_validate(Rs=np.linspace(100, 800, 15),
                     lambdas=np.logspace(1, -15, 25, base=10.0))
    return interp1d(k.estm_x, k.values(), axis=0, bounds_error=False,
                    fill_value=0.0)(np.asarray(z).reshape(-1))


def _shift_stage(model, lfp, resid, evoked_csd, z, x, t, timings=None):
    """Watershed-segment the evoked CSD, forward-model each segment to LFP
    space, estimate per-trial shifts, and build the Fisher-z correlation
    graph (reference ``:152-189``, ``:198-204``, ``:311-328``, ``:374-400``).
    The segments' LFP and the shift fit are on the model's device.
    """
    dev = model.device
    with stage(timings, "segmentation", dev):
        labels, n_seg = segment_csd(evoked_csd, rel_threshold=0.45, min_distance=12)

    # forward-model each segment back to LFP space; the 2/R factor cancels
    # the fwd-model gain because csd_pred lives in the model's internal CSD
    # units (reference ``fit_mean_function.py:198-204``)
    R_fit = model.R["value"]
    gain = 2.0 / R_fit
    csd = config.on_device(evoked_csd, dev)
    lab = torch.as_tensor(labels, device=dev)
    zt, xt = config.on_device(z, dev), config.on_device(x, dev)

    def seg_lfp(s):
        return gain * fwd_model_1d(torch.where(lab == s, csd, 0.0), zt, xt, R_fit)

    mu_components = (torch.stack([seg_lfp(s) for s in range(1, n_seg + 1)]) if n_seg
                     else torch.zeros((0, x.size, t.size), dtype=csd.dtype, device=dev))
    background = seg_lfp(0)

    # per-trial shifts via the GP factors of the noise fit
    model.update_lfp(resid, t.reshape(-1, 1))
    with torch.no_grad():
        factors = model._fns().build_factors(model._theta())
    with stage(timings, "shifts", dev):
        res = estimate_shifts(lfp, background, mu_components, t, factors,
                              prior_mu=0.0, prior_sd=10.0, device=dev)

    ns = res.tau.shape[1]
    if ns > 1:
        # a segment whose shifts are constant across trials (degenerate at
        # tiny test sizes) has zero stddev; report zero correlation for it
        # instead of letting corrcoef emit NaN + RuntimeWarning
        with np.errstate(invalid="ignore", divide="ignore"):
            shift_corr = np.corrcoef(res.tau.T)
        shift_corr = np.where(np.isfinite(shift_corr), shift_corr, 0.0)
        np.fill_diagonal(shift_corr, 1.0)
    else:
        shift_corr = np.ones((1, 1))
    zf = np.arctanh(np.clip(shift_corr, -0.999999, 0.999999))
    se = 1.0 / np.sqrt(max(lfp.shape[2] - 3, 1))
    from scipy.stats import norm

    pvals = 2 * (1 - norm.cdf(np.abs(zf) / se))
    return labels, n_seg, res, shift_corr, pvals


def surrogate(nx=24, nt=60, ntrials=40, shift_sd_true=3.0, seed=0):
    """Per-trial LFP of the two template components shifted by known
    amounts, plus noise; the true evoked CSD (shift-averaged).  Returns
    numpy (x, t, z, lfp (nx, nt, ntrials), truth_evoked_csd, tau_true)."""
    rng = np.random.default_rng(seed)
    a, b, R_true = 0.0, 2300.0, 150.0
    x = np.linspace(a, b, nx)
    t = np.linspace(0, 60, nt)
    z = np.linspace(a, b, 93)

    comps_csd = _template_components(z, t)  # dense CSD components
    tau_true = shift_sd_true * rng.standard_normal((ntrials, len(comps_csd)))
    lfp = np.zeros((nx, nt, ntrials))
    truth_evoked_csd = np.zeros((z.size, nt))
    comp_lfp = [fwd_model_1d(c, z, x, R_true).numpy() for c in comps_csd]
    for tr in range(ntrials):
        for i, (cc, cl) in enumerate(zip(comps_csd, comp_lfp)):
            shifted = np.array(
                [np.interp(t + tau_true[tr, i], t, cl[ch]) for ch in range(nx)]
            )
            lfp[:, :, tr] += shifted
            truth_evoked_csd += (
                np.array([np.interp(t + tau_true[tr, i], t, cc[zi])
                          for zi in range(z.size)])
                / ntrials
            )
    lfp /= np.max(np.abs(lfp))
    lfp += 0.03 * rng.standard_normal(lfp.shape)
    return x, t, z, lfp, truth_evoked_csd, tau_true


def run(nx=24, nt=60, ntrials=40, n_restarts=3, shift_sd_true=3.0, seed=0,
        results_dir=None, kcsd=True, device=config.DEFAULT_DEVICE, timings=None):
    """The surrogate pipeline; returns (metrics, ShiftResult, tau_true).

    :param timings: a dict to which each stage's seconds are added
        (``surrogate``, ``fit``, ``predict``, ``kcsd``, ``segmentation``,
        ``shifts``), or None.
    """
    dev = config.get_device(device)
    with stage(timings, "surrogate", dev):
        x, t, z, lfp, truth_evoked_csd, tau_true = surrogate(nx, nt, ntrials, shift_sd_true, seed)

    # fit the GP noise model on the de-evoked residual
    resid = lfp - lfp.mean(axis=2, keepdims=True)
    with stage(timings, "fit", dev):
        model = GPCSD1D(resid, x.reshape(-1, 1), t.reshape(-1, 1), device=dev)
        model.fit(n_restarts=n_restarts, seed=seed)

    # evoked mean CSD on the dense grid
    with stage(timings, "predict", dev):
        model.update_lfp(lfp.mean(axis=2, keepdims=True), t.reshape(-1, 1))
        model.predict(z.reshape(-1, 1), t.reshape(-1, 1))
        evoked_csd = model.csd_pred[:, :, 0]

    metrics = {}
    if kcsd:
        # kCSD evoked-response comparison (reference ``:113-115``): both
        # estimators scored against the known shift-averaged evoked CSD
        with stage(timings, "kcsd", dev):
            kcsd_evoked = _kcsd_evoked(x, lfp.mean(axis=2), model.R["value"], z)

        def _corr(u, v):
            return float(np.corrcoef(u.ravel(), v.ravel())[0, 1])

        metrics["gpcsd_evoked_corr"] = _corr(evoked_csd, truth_evoked_csd)
        metrics["kcsd_evoked_corr"] = _corr(kcsd_evoked, truth_evoked_csd)

    labels, n_seg, res, shift_corr, pvals = _shift_stage(
        model, lfp, resid, evoked_csd, z, x, t, timings
    )

    # correlate estimated component shifts against the injected truth: each
    # segment belongs to one template component; match greedily by |corr|
    cors = np.zeros((res.tau.shape[1], tau_true.shape[1]))
    for i in range(res.tau.shape[1]):
        for j in range(tau_true.shape[1]):
            cors[i, j] = np.corrcoef(res.tau[:, i], tau_true[:, j])[0, 1]
    best_match_corr = np.abs(cors).max(axis=1) if n_seg else np.array([0.0])

    ns = res.tau.shape[1]
    metrics.update({
        "n_segments": int(n_seg),
        "converged_frac": float(np.mean(res.converged)),
        "best_match_shift_corr_mean": float(best_match_corr.mean()),
        "best_match_shift_corr_max": float(best_match_corr.max()),
        "n_sig_shift_pairs": int(np.sum(pvals[np.triu_indices(ns, 1)] < 0.05)) if ns > 1 else 0,
    })
    report("fit_mean_function", metrics, results_dir)
    if results_dir:
        figures.draw(figures.fit_mean_function_figure, "fit_mean_function.png", z, t, evoked_csd,
                     labels, n_seg, res.tau, tau_true, shift_corr, results_dir)
    return metrics, res, tau_true


def run_real(data_dir, stage1_dir=None, n_restarts=10, seed=0, results_dir=None,
             kcsd=True, gdx=4.0, probes=("lateral", "medial"),
             device=config.DEFAULT_DEVICE, timings=None):
    """Real-data mode (reference ``fit_mean_function.py:55-128``): load the
    auditory text LFP *without* de-meaning, window 0-150 ms, restore the
    stage-1 hyperparameters from ``<stage1_dir>/gpcsd_model_<probe>.pkl``
    (the pickle the baseline workload writes; reference ``:97-99``), or
    fit fresh if absent, then run the evoked kCSD comparison and the
    segmentation + per-trial shift stages per probe.  Returns (metrics,
    {probe: results}).

    :param gdx: dense prediction-grid spacing in microns (the reference
        uses 1 um; 4 um keeps the default run light).
    :param timings: a dict to which each stage's seconds are added
        (``load``, ``fit``, ``predict``, ``kcsd``, ``segmentation``,
        ``shifts``), or None.
    """
    dev = config.get_device(device)
    x = np.linspace(A, B, NX)
    z = np.arange(A, B + 1e-9, gdx)
    metrics = {"source": "zenodo"}
    results = {}
    for probe in probes:
        with stage(timings, "load", dev):
            lfp, time = load_auditory_probe(data_dir, probe, demean=False)
        widx = (time >= 0) & (time <= 150.0)
        t = time[widx]
        lfp_w = lfp[:, widx, :]

        cache = os.path.join(stage1_dir, f"gpcsd_model_{probe}.pkl") if stage1_dir else None
        metrics[f"{probe}_stage1_restored"] = bool(cache and os.path.isfile(cache))
        with stage(timings, "fit", dev):
            model = fit_probe(lfp_w, t, n_restarts=n_restarts, seed=seed, cache=cache,
                              device=dev)
        metrics[f"{probe}_R"] = float(model.R["value"])

        with stage(timings, "predict", dev):
            model.predict(z.reshape(-1, 1), t.reshape(-1, 1))
            evoked_csd = model.csd_pred.mean(axis=2)
        if kcsd:
            with stage(timings, "kcsd", dev):
                kcsd_evoked = _kcsd_evoked(x, lfp_w.mean(axis=2), model.R["value"], z)
            # no ground truth on real data: record agreement between the
            # two estimators (normalized pattern correlation)
            metrics[f"{probe}_kcsd_gpcsd_corr"] = float(
                np.corrcoef(evoked_csd.ravel(), kcsd_evoked.ravel())[0, 1]
            )

        resid = lfp_w - lfp_w.mean(axis=2, keepdims=True)
        labels, n_seg, res, shift_corr, pvals = _shift_stage(
            model, lfp_w, resid, evoked_csd, z, x, t, timings
        )
        ns = res.tau.shape[1]
        metrics[f"{probe}_n_segments"] = int(n_seg)
        metrics[f"{probe}_converged_frac"] = float(np.mean(res.converged))
        metrics[f"{probe}_n_sig_shift_pairs"] = (
            int(np.sum(pvals[np.triu_indices(ns, 1)] < 0.05)) if ns > 1 else 0
        )
        results[probe] = dict(evoked_csd=evoked_csd, labels=labels, res=res,
                              shift_corr=shift_corr, pvals=pvals)

    report("fit_mean_function", metrics, results_dir)
    return metrics, results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--results-dir", default=None)
    p.add_argument("--data-dir", default=None,
                   help="auditory text-data directory (real-data mode)")
    p.add_argument("--stage1-dir", default=None,
                   help="directory with the baseline workload's "
                        "gpcsd_model_<probe>.pkl pickles to restore")
    p.add_argument("--device", default=config.DEFAULT_DEVICE)
    args = p.parse_args(argv)
    if args.data_dir:
        run_real(args.data_dir, stage1_dir=args.stage1_dir,
                 n_restarts=3 if args.quick else 10,
                 results_dir=args.results_dir, device=args.device)
    elif args.quick:
        run(nt=40, ntrials=20, n_restarts=2, results_dir=args.results_dir, device=args.device)
    else:
        run(results_dir=args.results_dir, device=args.device)


if __name__ == "__main__":
    main()
