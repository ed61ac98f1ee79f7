"""Auditory two-probe LFP pipeline (reference Figures 2-3), twin of
``workloads/auditory_lfp.py`` on the PyTorch port.

Parity target: the reference ``auditory_lfp/fit_gpcsd_baseline.py`` +
``torus_graph_fit.py``:

1. a 24-electrode LFP per probe: the reference's text files (Zenodo record
   5137888) read by :func:`load_probe` when ``data_dir`` holds
   ``time.txt`` (rescaled /100, de-meaned across trials), else the JAX
   workload's surrogate, a GPCSD1D prior draw pushed through the forward
   model, with a 10 Hz oscillation whose phase is coupled across the two
   probes (the prior draw comes from numpy's generator, so it is not the
   JAX workload's array for the same seed);
2. GPCSD1D with the paper's covariance stack: padded integration bounds
   (a=-200, b=2600), Matern ell prior on (1, 20) ms, SE ell prior on
   (30, 100) ms, per-channel HalfNormal(0.1) noise; MAP fit on the baseline
   window (t < 0), L-BFGS batched over restarts (or NUTS);
3. posterior CSD/LFP on the trial window;
4. 8-12 Hz bandpass -> Hilbert phases at the window's midpoint -> PLV;
5. torus-graph phase-differences fit on the stacked two-probe phases (48
   channels) with a trial bootstrap of the partial PLV.

Stages 3-5 keep their tensors on the device.  With ``results_dir`` set,
the JAX workload's per-probe figure is drawn
(:func:`gpcsd_tpu_torch.workloads.figures.auditory_lfp_figure`) where
matplotlib imports.

Run: ``python -m gpcsd_tpu_torch.workloads.auditory_lfp [--data-dir PATH] [--quick] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from .. import config
from .. import signal as tsig
from ..io.loaders import load_auditory_probe
from ..models.covariances import (
    GPCSD1DSpatialCovSE,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
)
from ..models.gpcsd1d import GPCSD1D
from ..models.priors import HalfNormal, InvGamma
from ..models.torus_graph import bootstrap_partial_plv, torus_graph_fit
from ..ops.forward import fwd_model_1d
from . import figures
from .common import report, stage

FS = 1000.0  # Hz
A, B = 0.0, 2300.0
NX = 24


def load_probe(data_dir, probe):
    """(nx, ntime, ntrials) LFP and the time in ms from the reference's text
    files, through the native parallel parser (numpy fallback inside the
    loader); numpy arrays on the host."""
    return load_auditory_probe(data_dir, probe, n_electrodes=NX)


def synth_probe(seed, ntime=400, ntrials=60, coupled_phases=None, f_hz=10.0,
                device=config.DEFAULT_DEVICE):
    """Surrogate probe: GPCSD1D prior draw + forward model + a 10 Hz
    oscillation whose phase is trial-coupled across probes.  Returns numpy
    (lfp (nx, ntime, ntrials), time in ms, coupled_phases)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(A, B, NX)
    time = (np.arange(ntime) - ntime // 2) / FS * 1000.0  # ms, 0 at middle
    gen = GPCSD1D(np.zeros((NX, ntime, 1)), x.reshape(-1, 1), time.reshape(-1, 1), device=device)
    gen.R["value"] = 150.0
    gen.spatial_cov.params["ell"]["value"] = 300.0
    gen.temporal_cov_list[0].params["ell"]["value"] = 40.0
    gen.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    gen.temporal_cov_list[1].params["ell"]["value"] = 5.0
    gen.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
    gen.sig2n["value"] = 1e-4
    csd = gen.sample_prior(ntrials, seed=seed)
    xt = config.on_device(x, device)
    lfp = fwd_model_1d(config.on_device(np.moveaxis(csd, 2, 0), device), xt, xt, 150.0)
    lfp = np.array(np.moveaxis(lfp.cpu().numpy(), 0, 2))
    lfp /= np.max(np.abs(lfp))
    # inject a coherent 10 Hz component with per-trial phase
    if coupled_phases is None:
        coupled_phases = rng.uniform(0, 2 * np.pi, ntrials)
    chan_jitter = rng.normal(0, 0.6, size=(NX, 1, ntrials))  # decorrelate channels
    osc = 0.15 * np.sin(
        2 * np.pi * f_hz * time[None, :, None] / 1000.0
        + coupled_phases[None, None, :]
        + chan_jitter
    )
    depth_profile = np.exp(-0.5 * ((x - 1200.0) / 500.0) ** 2)[:, None, None]
    lfp = lfp + osc * depth_profile
    lfp = lfp + 0.05 * rng.normal(size=lfp.shape)
    return lfp, time, coupled_phases


def surrogate(seed=0, ntime=400, ntrials=60, device=config.DEFAULT_DEVICE):
    """The two probes of the surrogate: {name: (lfp, time)}, the medial
    probe's phases partially coupled to the lateral's."""
    rng = np.random.default_rng(seed)
    shared = rng.uniform(0, 2 * np.pi, ntrials)
    lag = 0.8 + 0.2 * rng.normal(size=ntrials)
    lfp_l, time, _ = synth_probe(seed, ntime, ntrials, coupled_phases=shared, device=device)
    lfp_m, _, _ = synth_probe(seed + 1, ntime, ntrials, coupled_phases=shared + lag, device=device)
    return {"lateral": (lfp_l, time), "medial": (lfp_m, time)}


def fit_probe(lfp_baseline, t, n_restarts=10, seed=0, nuts=False, cache=None,
              device=config.DEFAULT_DEVICE):
    """GPCSD1D with the paper's covariance stack, fitted (MAP, or NUTS
    posterior mean) or restored from ``cache``, a pickle of
    ``extract_model_params()`` that this function writes; the JAX
    workload's pickles restore here and the other way round."""
    x = np.linspace(A, B, NX).reshape(-1, 1)
    spatial_cov = GPCSD1DSpatialCovSE(x, a=-200.0, b=2600.0)
    matern_cov = GPCSDTemporalCovMatern(t.reshape(-1, 1))
    matern_cov.params["ell"]["prior"] = InvGamma.from_interval(1.0, 20.0)
    se_cov = GPCSDTemporalCovSE(t.reshape(-1, 1))
    se_cov.params["ell"]["prior"] = InvGamma.from_interval(30.0, 100.0)
    sig2n_prior = [HalfNormal(0.1) for _ in range(NX)]
    model = GPCSD1D(
        lfp_baseline, x, t.reshape(-1, 1),
        a=-200.0, b=2600.0,
        spatial_cov=spatial_cov,
        temporal_cov_list=[se_cov, matern_cov],
        sig2n_prior=sig2n_prior,
        device=device,
    )
    if cache and os.path.isfile(cache):
        with open(cache, "rb") as f:
            model.restore_model_params(pickle.load(f))
    elif nuts:
        model.sample_posterior(
            n_chains=2, num_warmup=200, num_samples=200, seed=seed,
            set_posterior_mean=True,
        )
    else:
        model.fit(n_restarts=n_restarts, seed=seed)
    if cache:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        with open(cache, "wb") as f:
            pickle.dump(model.extract_model_params(), f)
    return model


def probe_phases(model, lfp, time, timings=None, fig_data=None):
    """Posterior CSD and LFP on the trial window, then their 8-12 Hz phases
    at the window's midpoint (the reference's filtfilt + hilbert at a fixed
    time index, ``fit_gpcsd_baseline.py:303-308``).

    :param fig_data: None, or a dict that receives the probe's figure
        arrays on the host (``t``, ``lfp_evoked``, ``csd_evoked``,
        ``csd_components``, ``plv``), as the JAX workload collects them
    :return: (csd phases (nx, ntrials), lfp phases, CSD PLV (nx, nx)),
        tensors on the model's device
    """
    dev = model.device
    trial_idx = (time >= 0) & (time < min(500.0, time.max()))
    t_trial = time[trial_idx].reshape(-1, 1)
    x = np.linspace(A, B, NX).reshape(-1, 1)
    model.update_lfp(lfp[:, trial_idx, :], t_trial)
    with stage(timings, "predict", dev):
        pred = model.predict_tensors(x, t_trial, type="both")
    mid = t_trial.shape[0] // 2

    def band_phases(p):
        # p (ntrials, nx, nt), filtered along time -> phases (nx, ntrials)
        filt = tsig.bandpass_filtfilt(p, 8.0, 12.0, FS, device=dev)
        return tsig.instantaneous_phase(filt, device=dev)[:, :, mid].T

    with stage(timings, "phases", dev):
        csd_ph = band_phases(pred["csd"][0])
        lfp_ph = band_phases(pred["lfp"][0])
        plv = tsig.plv_matrix(csd_ph, device=dev)
    if fig_data is not None:
        total, comps = pred["csd"]
        fig_data.update(
            t=t_trial.reshape(-1), lfp_evoked=lfp[:, trial_idx, :].mean(axis=2),
            csd_evoked=total.mean(dim=0).cpu().numpy(),
            csd_components=[c.mean(dim=0).cpu().numpy() for c in comps],
            plv=plv.cpu().numpy())
    return csd_ph, lfp_ph, plv


def torus_stage(X, nboot, seed=0, device=config.DEFAULT_DEVICE, timings=None):
    """Torus-graph fit on the stacked phases X (d, ntrials) and the trial
    bootstrap of the partial PLV; returns (result, metrics)."""
    metrics = {}
    with stage(timings, "torus_graph", device):
        tg = torus_graph_fit(X, device=device)
        metrics["tg_edges_bonf_001"] = int(torch.sum(tg.pvals < 0.001 / (24 * 24)))
        metrics["tg_max_kappa"] = float(torch.max(tg.kappa))
    if nboot > 0:
        with stage(timings, "bootstrap", device):
            bs = bootstrap_partial_plv(X, nboot, generator=torch.Generator().manual_seed(seed),
                                       device=device).cpu().numpy()
        metrics["bootstrap_pplv_ci_width_mean"] = float(
            (np.quantile(bs, 0.975, axis=1) - np.quantile(bs, 0.025, axis=1)).mean()
        )
    return tg, metrics


def run(data_dir=None, n_restarts=10, nuts=False, nboot=10, seed=0, results_dir=None,
        ntime=400, ntrials=60, device=config.DEFAULT_DEVICE, timings=None):
    """The pipeline on the text files in ``data_dir`` (when it holds
    ``time.txt``) or on the surrogate; returns (metrics, phases,
    torus-graph result).

    :param timings: a dict to which each stage's seconds are added
        (``load`` or ``surrogate``, ``fit``, ``predict``, ``phases``,
        ``torus_graph``, ``bootstrap``), or None.
    """
    dev = config.get_device(device)
    if data_dir and os.path.isfile(os.path.join(data_dir, "time.txt")):
        with stage(timings, "load", dev):
            probes = {p: load_probe(data_dir, p) for p in ("lateral", "medial")}
        source = "zenodo"
    else:
        with stage(timings, "surrogate", dev):
            probes = surrogate(seed, ntime, ntrials, device=dev)
        source = "surrogate"
    phases = {}
    fig_data = {}
    metrics = {"source": source}
    for pname, (lfp, time) in probes.items():
        baseline_idx = time < 0
        with stage(timings, "fit", dev):
            model = fit_probe(
                lfp[:, baseline_idx, :], time[baseline_idx], n_restarts=n_restarts,
                seed=seed, nuts=nuts, device=dev,
                cache=os.path.join(results_dir, f"gpcsd_model_{pname}.pkl") if results_dir else None,
            )
        metrics[f"{pname}_R"] = float(model.R["value"])
        metrics[f"{pname}_spatial_ell"] = float(model.spatial_cov.params["ell"]["value"])
        csd_ph, lfp_ph, plv = probe_phases(
            model, lfp, time, timings, fig_data=fig_data.setdefault(pname, {}) if results_dir else None)
        phases[pname] = {"csd": csd_ph, "lfp": lfp_ph}
        off = ~torch.eye(NX, dtype=torch.bool, device=dev)
        metrics[f"{pname}_mean_offdiag_plv"] = float(plv[off].mean())

    # torus-graph phase-differences fit on stacked probes (48 channels)
    X = torch.cat([phases["lateral"]["csd"], phases["medial"]["csd"]])
    tg, tg_metrics = torus_stage(X, nboot, seed, device=dev, timings=timings)
    metrics.update(tg_metrics)
    report("auditory_lfp", metrics, results_dir)
    if results_dir:
        figures.draw(figures.auditory_lfp_figure, "auditory_lfp_<probe>.png", fig_data, results_dir)
    return metrics, phases, tg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default=None)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--nuts", action="store_true", help="NUTS posterior instead of MAP")
    p.add_argument("--results-dir", default=None)
    p.add_argument("--device", default=config.DEFAULT_DEVICE)
    args = p.parse_args(argv)
    kw = dict(data_dir=args.data_dir, nuts=args.nuts, results_dir=args.results_dir,
              device=args.device)
    if args.quick:
        kw.update(n_restarts=3, nboot=4, ntime=200, ntrials=30)
    run(**kw)


if __name__ == "__main__":
    main()
