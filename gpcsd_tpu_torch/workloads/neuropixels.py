"""Neuropixels 2D LFP + torus-graph pipeline (reference Figure 6), twin of
``workloads/neuropixels.py`` on the PyTorch port.

Parity target: the reference ``neuropixels/fit_gpcsd2d.py`` +
``fit_torus_graph.py``:

1. per-probe (V1 + LM) 2D-geometry LFP epochs, window -40..110 ms, /100
   rescale, de-evoked, outlier-trial rejection (> 5 SD);
2. GPCSD2D with R prior on (50, 300), SE ell prior (20, 200), Matern ell
   prior (1, 20), eps=1, ngl 30x120, padded integration domain;
3. MAP fit (reference: 20 restarts; L-BFGS batched over restarts on the
   device), CSD prediction at 4 depths per probe;
4. theta (3-7 Hz) / beta (15-25 Hz) band-pass + Hilbert phases at t = 0 and
   70 ms -> torus-graph fit on the stacked probes (d = 8) per band x time,
   plus a trial bootstrap of the conditional coupling (partial PLV) per
   band x time (reference ``fit_torus_graph.py:47-66``; paper nboot = 1000),
   its resampling drawn from a ``torch.Generator`` seeded
   ``seed + 1000 + band-time index``.

``data_dir`` holds the two probes' pickles in
:func:`gpcsd_tpu_torch.io.nwb.extract_probe`'s schema
(``neuropixel_viz_{probe}_m405751.pkl``); without it a surrogate two-probe
dataset with Neuropixels-like geometry is drawn from a GPCSD2D prior on the
device (numpy's generator, so not the JAX workload's array for the same
seed).  With ``results_dir`` set, the JAX workload's per-probe layer figure
is drawn (:func:`gpcsd_tpu_torch.workloads.figures.neuropixels_layer_figure`)
where matplotlib imports.

Run: ``python -m gpcsd_tpu_torch.workloads.neuropixels [--data-dir PATH] [--quick] [--device cpu]``
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from .. import config
from .. import signal as tsig
from ..models.covariances import GPCSDTemporalCovMatern, GPCSDTemporalCovSE
from ..models.gpcsd2d import GPCSD2D
from ..models.priors import InvGamma
from ..models.torus_graph import bootstrap_partial_plv, torus_graph_fit
from . import figures
from .common import report, stage

PROBES = ("probeC", "probeD")


def neuropixels_geometry(nrows=18, staggered=True):
    """Approximate Neuropixels checkerboard: 2 columns x nrows, 16/24 um."""
    xs, ys = [], []
    for r in range(nrows):
        for c in range(2):
            xs.append(16.0 + 32.0 * c + (8.0 if (staggered and r % 2) else 0.0))
            ys.append(2200.0 + 20.0 * r)
    return np.stack([np.asarray(xs), np.asarray(ys)], axis=1)


def outlier_trials(lfp, thresh=5.0):
    """Keep trials with no sample exceeding thresh x the per-(channel, time)
    SD across trials (reference ``fit_gpcsd2d.py:51-70``)."""
    sd = np.std(lfp, axis=2, keepdims=True)
    bad = np.any(np.abs(lfp) > thresh * sd, axis=(0, 1))
    return ~bad


def _domain(x):
    """The padded integration domain around the sites."""
    return dict(a1=x[:, 0].min() - 16, b1=x[:, 0].max() + 16,
                a2=x[:, 1].min() - 100, b2=x[:, 1].max() + 100)


def synth_probe(x, nt=150, ntrials=40, seed=0, device=config.DEFAULT_DEVICE):
    """LFP prior draw of a GPCSD2D at fixed parameters (ngl 10 x 30) plus
    noise, the first ``ntrials // 20`` trials scaled 8x as outliers; numpy
    (lfp (nx, nt, ntrials), t (nt, 1) in ms)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(-40, 110, nt).reshape(-1, 1)
    gen = GPCSD2D(np.zeros((x.shape[0], nt, 1)), x, t, eps=1.0, ngl1=10, ngl2=30,
                  device=device, **_domain(x))
    gen.R["value"] = 80.0
    gen.spatial_cov.params["ell1"]["value"] = 30.0
    gen.spatial_cov.params["ell2"]["value"] = 100.0
    gen.temporal_cov_list[0].params["ell"]["value"] = 20.0
    gen.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    gen.temporal_cov_list[1].params["ell"]["value"] = 3.0
    gen.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
    gen.sig2n["value"] = 0.1
    _, lfp = gen.sample_prior(ntrials, type="lfp", seed=seed)
    lfp = np.array(lfp)
    lfp += np.sqrt(0.1) * rng.normal(size=lfp.shape)
    # a couple of artificial outlier trials to exercise rejection
    lfp[:, :, : max(1, ntrials // 20)] *= 8.0
    return lfp, t


def fit_probe(lfp, x, t, n_restarts=20, ngl1=30, ngl2=120, seed=0, cache=None,
              device=config.DEFAULT_DEVICE):
    """GPCSD2D with the paper's priors, fitted or restored from ``cache``, a
    pickle of ``extract_model_params()`` that this function writes (the JAX
    workload's pickles restore here and the other way round)."""
    se = GPCSDTemporalCovSE(t, ell_prior=InvGamma.from_interval(20, 200))
    ma = GPCSDTemporalCovMatern(t, ell_prior=InvGamma.from_interval(1, 20))
    model = GPCSD2D(lfp, x, t, R_prior=InvGamma.from_interval(50, 300),
                    temporal_cov_list=[se, ma], eps=1.0, ngl1=ngl1, ngl2=ngl2,
                    device=device, **_domain(x))
    if cache and os.path.isfile(cache):
        with open(cache, "rb") as f:
            model.restore_model_params(pickle.load(f))
    else:
        model.fit(n_restarts=n_restarts, seed=seed)
        if cache:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            with open(cache, "wb") as f:
                pickle.dump(model.extract_model_params(), f)
    return model


def load_probes(data_dir):
    """The two probes' pickles, windowed to -40..110 ms, /100, de-evoked:
    {probe: (lfp, x, t (nt, 1) in ms)}."""
    probes = {}
    for probe in PROBES:
        with open(os.path.join(data_dir, f"neuropixel_viz_{probe}_m405751.pkl"), "rb") as f:
            d = pickle.load(f)
        t = d["t"] * 1000.0
        t_ind = (t >= -40.0) & (t <= 110.0)
        lfp = d["y"][:, t_ind.ravel(), :] / 100.0
        lfp -= lfp.mean(2, keepdims=True)
        probes[probe] = (lfp, d["x"], t[t_ind].reshape(-1, 1))
    return probes


def band_phases(csd_pred, t, bands, phase_times, device=config.DEFAULT_DEVICE):
    """Band-pass + Hilbert phases of the (ndepth, nt, ntrials) CSD at the
    samples nearest ``phase_times`` (ms): {(lo, hi, time): (ndepth,
    ntrials) tensor} (reference ``fit_gpcsd2d.py:140-159``)."""
    t = np.asarray(t).ravel()
    t_inds = [int(np.argmin(np.abs(t - tt))) for tt in phase_times]
    fs = 1000.0 / float(np.mean(np.diff(t)))  # t is in ms
    v = config.on_device(np.moveaxis(csd_pred, 1, -1), device)  # (ndepth, ntrials, nt)
    out = {}
    for lo, hi in bands:
        ph_all = tsig.instantaneous_phase(tsig.bandpass_filtfilt(v, lo, hi, fs, device=device),
                                          device=device)
        for tt, ti in zip(phase_times, t_inds):
            out[(lo, hi, tt)] = ph_all[:, :, ti]
    return out


def torus_metrics(X, tag, device=config.DEFAULT_DEVICE):
    """Torus-graph fit on the stacked phases X (d, ntrials): (metrics under
    ``tag``, fit)."""
    tg = torus_graph_fit(X, device=device)
    return {f"{tag}_edges_bonf": int(torch.sum(tg.pvals < 0.05 / tg.pairs.shape[0]))}, tg


def bootstrap_metrics(X, tag, nboot, generator=None, indices=None, device=config.DEFAULT_DEVICE):
    """Trial bootstrap of the partial PLV on X (d, ntrials) and its 95%
    interval: (metrics under ``tag``, replicates (npairs, nboot) numpy,
    2.5% and 97.5% percentiles)."""
    pplv = bootstrap_partial_plv(X, nboot, generator=generator, indices=indices,
                                 device=device).cpu().numpy()
    lo_q, hi_q = np.percentile(pplv, [2.5, 97.5], axis=1)
    return ({f"{tag}_pplv_ci_width_mean": float(np.mean(hi_q - lo_q)),
             f"{tag}_pplv_ci_lo_max": float(np.max(lo_q))}, pplv, lo_q, hi_q)


def run(data_dir=None, n_restarts=20, ngl1=30, ngl2=120, nt=150, ntrials=40,
        seed=0, results_dir=None, bands=((3, 7), (15, 25)),
        phase_times=(0.0, 70.0), nboot=1000, device=config.DEFAULT_DEVICE, timings=None):
    """The pipeline; returns its metrics.

    :param timings: a dict to which each stage's seconds are added
        (``load`` or ``surrogate``, ``fit``, ``predict``, ``phases``,
        ``torus_graph``, ``bootstrap``), or None.
    """
    dev = config.get_device(device)
    if data_dir:
        with stage(timings, "load", dev):
            probes = load_probes(data_dir)
        source = "nwb"
    else:
        x = neuropixels_geometry()
        probes = {}
        with stage(timings, "surrogate", dev):
            for i, probe in enumerate(PROBES):
                lfp, t = synth_probe(x, nt=nt, ntrials=ntrials, seed=seed + i, device=dev)
                probes[probe] = (lfp, x, t)
        source = "surrogate"

    metrics = {"source": source}
    phases = {}
    for pi, (probe, (lfp, x, t)) in enumerate(probes.items()):
        keep = outlier_trials(lfp)
        metrics[f"{probe}_trials_kept"] = int(keep.sum())
        lfp = lfp[:, :, keep]
        with stage(timings, "fit", dev):
            model = fit_probe(
                lfp, x, t, n_restarts=n_restarts, ngl1=ngl1, ngl2=ngl2, seed=seed + 13 * pi,
                cache=os.path.join(results_dir, f"{probe}_params.pkl") if results_dir else None,
                device=dev,
            )
        metrics[f"{probe}_R"] = float(model.R["value"])
        metrics[f"{probe}_ell1"] = float(model.spatial_cov.params["ell1"]["value"])
        metrics[f"{probe}_ell2"] = float(model.spatial_cov.params["ell2"]["value"])

        # CSD at 4 depths down the probe mid-line
        depths = np.linspace(x[:, 1].min() + 50, x[:, 1].max() - 50, 4)
        z = np.stack([np.full(4, x[:, 0].mean()), depths], axis=1)
        with stage(timings, "predict", dev):
            model.predict(z, t, type="csd")
        metrics[f"{probe}_csd_pred_shape"] = list(model.csd_pred.shape)
        if results_dir:
            figures.draw(figures.neuropixels_layer_figure, f"neuropixels_{probe}_layers.png",
                         probe, t.ravel(), depths, model.csd_pred, results_dir)
        with stage(timings, "phases", dev):
            for key, ph in band_phases(model.csd_pred, t, bands, phase_times, dev).items():
                phases.setdefault(key, {})[probe] = ph

    # torus-graph fit + trial bootstrap per band x time on stacked probes
    # (reference ``neuropixels/fit_torus_graph.py:25-37`` fit, ``:47-66``
    # bootstrap of conditional coupling / partial PLV)
    for bi, ((lo, hi, tt), per_probe) in enumerate(sorted(phases.items())):
        X = torch.cat([per_probe["probeC"], per_probe["probeD"]])
        tag = f"tg_{lo}_{hi}_t{int(tt)}"
        with stage(timings, "torus_graph", dev):
            m, tg = torus_metrics(X, tag, device=dev)
        metrics.update(m)
        if nboot:
            with stage(timings, "bootstrap", dev):
                m, pplv, lo_q, hi_q = bootstrap_metrics(
                    X, tag, nboot, generator=torch.Generator().manual_seed(seed + 1000 + bi),
                    device=dev)
            metrics.update(m)
            if results_dir:
                np.savez(os.path.join(results_dir, f"bootstrap_{tag}.npz"),
                         pplv=pplv, ci_lo=lo_q, ci_hi=hi_q,
                         cond_coupling=tg.cond_coupling.cpu().numpy(),
                         pvals=tg.pvals.cpu().numpy(), pairs=np.asarray(tg.pairs))

    report("neuropixels", metrics, results_dir)
    return metrics


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default=None)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--results-dir", default=None)
    p.add_argument("--nboot", type=int, default=1000,
                   help="torus-graph bootstrap iterations (paper = 1000)")
    p.add_argument("--device", default=config.DEFAULT_DEVICE)
    args = p.parse_args(argv)
    kw = dict(data_dir=args.data_dir, results_dir=args.results_dir, nboot=args.nboot,
              device=args.device)
    if args.quick:
        kw.update(n_restarts=3, ngl1=8, ngl2=24, nt=80, ntrials=20)
        if args.nboot == 1000:
            kw["nboot"] = 4
    run(**kw)


if __name__ == "__main__":
    main()
