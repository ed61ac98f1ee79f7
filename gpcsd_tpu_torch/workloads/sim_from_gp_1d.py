"""Simulate-from-the-model 1D study (reference Figure: GP recovery), twin of
``workloads/sim_from_gp_1d.py`` on the PyTorch port.

Parity target: the reference ``simulation_studies/sim_from_gp_1D.py``:
draw CSD trials from a GPCSD1D generator with known hyperparameters
(R=100, spatial ell=200, Matern sigma2=0.7/ell=5, SE sigma2=0.5/ell=20,
sig2n=1e-4), forward-model to 24 electrodes, add noise, fit a fresh model
(or inject the truth with ``fix=True``), and score per-trial MSE/R^2 of the
posterior CSD against the generated CSD, with paired t-tests against the
traditional-CSD baseline and, with ``kcsd=True``, against cross-validated
kCSD.  The prior draw and the forward model run on the device; the prior
draw comes from numpy's generator, so it is not the JAX workload's array
for the same seed.  With ``results_dir`` set, the JAX workload's figure is
drawn (:func:`gpcsd_tpu_torch.workloads.figures.sim_from_gp_1d_figure`)
where matplotlib imports.

Run: ``python -m gpcsd_tpu_torch.workloads.sim_from_gp_1d [--quick] [--fix] [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import config
from ..models.gpcsd1d import GPCSD1D
from ..models.trad import predictcsd_trad_1d
from ..ops.forward import fwd_model_1d
from . import figures
from .common import mse, paired_t, r2, report, stage

TRUE = dict(R=100.0, ell=200.0, se_sigma2=0.5, se_ell=20.0,
            m_sigma2=0.7, m_ell=5.0, sig2n=1e-4)


def make_generator(x, t, device=config.DEFAULT_DEVICE):
    """GPCSD1D at the :data:`TRUE` parameters on the sites x and times t."""
    gen = GPCSD1D(np.zeros((x.size, t.size, 1)), x.reshape(-1, 1), t.reshape(-1, 1),
                  device=device)
    gen.R["value"] = TRUE["R"]
    gen.spatial_cov.params["ell"]["value"] = TRUE["ell"]
    gen.temporal_cov_list[0].params["ell"]["value"] = TRUE["se_ell"]
    gen.temporal_cov_list[0].params["sigma2"]["value"] = TRUE["se_sigma2"]
    gen.temporal_cov_list[1].params["ell"]["value"] = TRUE["m_ell"]
    gen.temporal_cov_list[1].params["sigma2"]["value"] = TRUE["m_sigma2"]
    gen.sig2n["value"] = TRUE["sig2n"]
    return gen


def surrogate(ntrials=100, nt=60, nx=24, seed=42, device=config.DEFAULT_DEVICE):
    """Prior CSD draws at the electrodes, their LFP (forward model on
    ``device``, normalized) plus white noise.  Returns numpy (x, t,
    csd (nx, nt, ntrials), lfp (nx, nt, ntrials), scale)."""
    x = np.linspace(0.0, 2300.0, nx)
    t = np.linspace(0, 60, nt)
    csd_at_x = make_generator(x, t, device).sample_prior(ntrials, seed=seed)
    xt = config.on_device(x, device)
    lfp = fwd_model_1d(config.on_device(np.moveaxis(csd_at_x, 2, 0), device), xt, xt, TRUE["R"])
    lfp = np.moveaxis(lfp.cpu().numpy(), 0, 2)
    scale = np.max(np.abs(lfp))
    lfp = lfp / scale
    rng = np.random.default_rng(seed + 1)
    lfp = lfp + np.sqrt(TRUE["sig2n"]) * rng.normal(size=lfp.shape)
    return x, t, csd_at_x, lfp, scale


def set_oracle(model, scale):
    """Inject the true parameters, with the forward gain R/2 and the
    normalization absorbed into the temporal variances."""
    gain = (TRUE["R"] / 2.0 / scale) ** 2
    model.R["value"] = TRUE["R"]
    model.spatial_cov.params["ell"]["value"] = TRUE["ell"]
    model.temporal_cov_list[0].params["ell"]["value"] = TRUE["se_ell"]
    model.temporal_cov_list[0].params["sigma2"]["value"] = TRUE["se_sigma2"] * gain
    model.temporal_cov_list[1].params["ell"]["value"] = TRUE["m_ell"]
    model.temporal_cov_list[1].params["sigma2"]["value"] = TRUE["m_sigma2"] * gain
    model.sig2n["value"] = TRUE["sig2n"]


def _norm(v):
    """Each trial scaled by its largest magnitude, as the reference compares."""
    return v / np.max(np.abs(v), axis=(0, 1), keepdims=True)


def kcsd_scores(x, lfp, truth_n, gp_mse):
    """kCSD, reference protocol (``sim_from_gp_1D.py:112-127``):
    cross-validate (R, lambda) on the first 5 trials concatenated, then
    estimate every trial at the selected parameters and interpolate back to
    the electrode grid.  Returns (metrics, normalized kCSD)."""
    from scipy.interpolate import interp1d

    from ..models.kcsd import KCSD1D

    nx, _, ntrials = lfp.shape
    deltax = float(x[1] - x[0])
    ncv = min(5, ntrials)
    kc = KCSD1D(x.reshape(-1, 1), lfp[:, :, :ncv].reshape(nx, -1), gdx=deltax / 4, h=TRUE["R"])
    kc.cross_validate(Rs=np.linspace(100, 1000, 8))
    kcsd_vals = np.empty_like(lfp)
    for i in range(ntrials):
        kci = KCSD1D(x.reshape(-1, 1), lfp[:, :, i], gdx=deltax / 4, h=TRUE["R"],
                     R_init=kc.R, lambd=kc.lambd)
        kcsd_vals[:, :, i] = interp1d(kci.estm_x, kci.values(), axis=0)(x)
    kcsd_n = _norm(kcsd_vals)
    k_mse = np.array([mse(kcsd_n[:, :, i], truth_n[:, :, i]) for i in range(ntrials)])
    ktt, ktp = paired_t(gp_mse, k_mse)
    return dict(kcsd_mse_mean=float(k_mse.mean()), kcsd_R=float(kc.R),
                kcsd_lambda=float(kc.lambd), paired_t_gp_vs_kcsd=float(ktt),
                paired_p_gp_vs_kcsd=float(ktp)), kcsd_n


def run(ntrials=100, nt=60, nx=24, n_restarts=10, fix=False, seed=42,
        results_dir=None, kcsd=False, device=config.DEFAULT_DEVICE, timings=None):
    """The study; returns (metrics, model).

    :param timings: a dict to which each stage's seconds are added
        (``surrogate``, ``fit``, ``predict``, ``tcsd``, ``kcsd``), or None.
    """
    dev = config.get_device(device)
    with stage(timings, "surrogate", dev):
        x, t, csd_at_x, lfp, scale = surrogate(ntrials, nt, nx, seed, dev)

    with stage(timings, "fit", dev):
        model = GPCSD1D(lfp, x.reshape(-1, 1), t.reshape(-1, 1), device=dev)
        if fix:
            set_oracle(model, scale)
        else:
            model.fit(n_restarts=n_restarts, seed=seed)

    with stage(timings, "predict", dev):
        model.predict(x.reshape(-1, 1), t.reshape(-1, 1))
    gp_pred = model.csd_pred  # (nx, nt, ntrials)
    with stage(timings, "tcsd", dev):
        tcsd = predictcsd_trad_1d(lfp)

    # per-trial scores against the generated CSD (normalized per trial as in
    # the reference comparison)
    truth_n = _norm(csd_at_x)
    gp_n = _norm(gp_pred)
    t_n = _norm(np.where(tcsd == 0, 1e-12, tcsd))
    gp_mse = np.array([mse(gp_n[:, :, i], truth_n[:, :, i]) for i in range(ntrials)])
    t_mse = np.array([mse(t_n[1:-1, :, i], truth_n[1:-1, :, i]) for i in range(ntrials)])
    gp_r2 = np.array([r2(gp_n[:, :, i], truth_n[:, :, i]) for i in range(ntrials)])
    tt, tp = paired_t(gp_mse, t_mse)

    metrics = {
        "gpcsd_mse_mean": float(gp_mse.mean()),
        "gpcsd_mse_median": float(np.median(gp_mse)),
        "tcsd_mse_mean": float(t_mse.mean()),
        "gpcsd_r2_mean": float(gp_r2.mean()),
        "paired_t_gp_vs_tcsd": float(tt),
        "paired_p_gp_vs_tcsd": float(tp),
        "fitted_R": float(model.R["value"]),
        "fitted_spatial_ell": float(model.spatial_cov.params["ell"]["value"]),
        "fitted_sig2n": float(np.asarray(model.sig2n["value"])),
    }
    kcsd_n = None
    if kcsd:
        with stage(timings, "kcsd", dev):
            kcsd_metrics, kcsd_n = kcsd_scores(x, lfp, truth_n, gp_mse)
        metrics.update(kcsd_metrics)

    tag = "_fix" if fix else ""
    report("sim_from_gp_1d" + tag, metrics, results_dir)
    if results_dir:
        figures.draw(figures.sim_from_gp_1d_figure, f"sim_from_gp_1d{tag}.png", x, t, truth_n,
                     gp_n, t_n, kcsd_n, gp_mse, t_mse, results_dir, tag=tag)
    return metrics, model


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--fix", action="store_true", help="oracle: inject true params")
    p.add_argument("--no-kcsd", action="store_true", help="skip the kCSD baseline")
    p.add_argument("--results-dir", default=None)
    p.add_argument("--device", default=config.DEFAULT_DEVICE)
    args = p.parse_args(argv)
    kw = dict(fix=args.fix, results_dir=args.results_dir, kcsd=not args.no_kcsd,
              device=args.device)
    if args.quick:
        kw.update(ntrials=20, nt=40, n_restarts=3)
    run(**kw)


if __name__ == "__main__":
    main()
