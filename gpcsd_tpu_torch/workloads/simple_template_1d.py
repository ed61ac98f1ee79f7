"""Simple-template 1D simulation (reference Figure 1 pipeline), twin of
``workloads/simple_template_1d.py`` on the PyTorch port.

Parity target: the reference ``simulation_studies/simple_template_1D.py``:
a toy 4-dipole CSD template pushed through the 1D forward model, white
noise at SNR 30, GPCSD fit with 10 restarts (L-BFGS batched over restarts
on the device), posterior CSD on the dense grid, traditional CSD, and kCSD
with cross-validation (:mod:`gpcsd_tpu_torch.models.kcsd`, numpy on the
host) for comparison.  With ``results_dir`` set, the JAX workload's figure is
drawn (:func:`gpcsd_tpu_torch.workloads.figures.simple_template_1d_figure`)
where matplotlib imports.

Run: ``python -m gpcsd_tpu_torch.workloads.simple_template_1d [--quick] [--device cpu]``
"""

from __future__ import annotations

import argparse
import time as _time

import numpy as np

from .. import config
from ..models.gpcsd1d import GPCSD1D
from ..models.kcsd import KCSD1D
from ..models.trad import predictcsd_trad_1d
from ..ops.forward import fwd_model_1d
from ..utils.grids import normalize
from . import figures
from .common import mse, r2, report, stage


def csd_true_f(x, t):
    """Toy CSD with two dipole pairs (reference ``simple_template_1D.py:19-31``)."""
    x = np.asarray(x).reshape(-1, 1)
    t = np.asarray(t).reshape(1, -1)
    comp1 = np.exp(-((x - 200) ** 2) / (2 * 150**2)) * np.exp(-((t - 25) ** 2) / (2 * 3**2))
    comp2 = -np.exp(-((x - 800) ** 2) / (2 * 150**2)) * np.exp(-((t - 25) ** 2) / (2 * 4**2))
    comp3 = np.exp(-((x - 1600) ** 2) / (2 * 150**2)) * np.exp(-((t - 30) ** 2) / (2 * 4**2))
    comp4 = -np.exp(-((x - 2200) ** 2) / (2 * 150**2)) * np.exp(-((t - 30) ** 2) / (2 * 3**2))
    val = comp1 + comp2 + comp3 + comp4
    return val / np.max(np.abs(val))


def surrogate(deltaz=10.0, nt=50, nx=24, snr=30, seed=1, device=config.DEFAULT_DEVICE):
    """The template on the dense grid z, its LFP at the electrodes x (the
    forward model on ``device``) with and without white noise.  Returns
    numpy (x, z, t, csd_true (nz, nt), lfp_clean, lfp_noisy (nx, nt))."""
    rng = np.random.default_rng(seed)
    a, b, R_true = 0.0, 2400.0, 150.0
    t = np.linspace(0, 50, nt).reshape(-1, 1)
    x = np.linspace(a, b, nx).reshape(-1, 1)
    nz = int(np.rint((b - a) / deltaz)) + 1
    z = np.linspace(a, b, nz).reshape(-1, 1)
    csd_true = csd_true_f(z, t)
    lfp = fwd_model_1d(config.on_device(csd_true, device), config.on_device(z, device),
                       config.on_device(x, device), R_true)
    lfp_clean = normalize(lfp.cpu().numpy())
    sig2n_true = (np.std(lfp_clean) / snr) ** 2
    lfp_noisy = lfp_clean + rng.normal(0, np.sqrt(sig2n_true), size=lfp_clean.shape)
    return x, z, t, csd_true, lfp_clean, lfp_noisy


def run(n_restarts=10, deltaz=10.0, nt=50, nx=24, snr=30, seed=1, results_dir=None,
        device=config.DEFAULT_DEVICE, timings=None):
    """The pipeline on the noiseless and the white-noise LFP; returns
    (metrics, {name: (model, normalized GPCSD estimate)}).

    :param timings: a dict to which each stage's seconds are added
        (``surrogate``, ``fit``, ``predict``, ``tcsd``, ``kcsd``), or None.
    """
    dev = config.get_device(device)
    R_true = 150.0
    with stage(timings, "surrogate", dev):
        x, z, t, csd_true, lfp_clean, lfp_noisy = surrogate(deltaz, nt, nx, snr, seed, dev)

    metrics = {}
    preds = {}
    for name, lfp in (("noiseless", lfp_clean), ("white_noise", lfp_noisy)):
        with stage(timings, "fit", dev):
            model = GPCSD1D(lfp, x, t, device=dev)
            model.fit(n_restarts=n_restarts, seed=seed)
        with stage(timings, "predict", dev):
            model.predict(z, t)
        est = normalize(model.csd_pred[:, :, 0])
        truth = normalize(csd_true)
        with stage(timings, "tcsd", dev):
            tcsd = predictcsd_trad_1d(lfp[:, :, None])[:, :, 0]
        # compare tCSD at the electrodes against the true CSD there
        truth_at_x = normalize(csd_true_f(x, t))
        metrics[f"{name}_gpcsd_mse"] = float(mse(est, truth))
        metrics[f"{name}_gpcsd_r2"] = float(r2(est, truth))
        metrics[f"{name}_tcsd_mse"] = float(mse(normalize(tcsd), truth_at_x))
        metrics[f"{name}_fitted_R"] = float(model.R["value"])

        # kCSD with cross-validation (the reference uses the external kcsd
        # package here, ``simple_template_1D.py:99-107``)
        with stage(timings, "kcsd", dev):
            t0 = _time.process_time()
            kc = KCSD1D(x, lfp, gdx=deltaz, h=R_true)
            kc.cross_validate(Rs=np.linspace(100, 800, 8), lambdas=np.logspace(1, -15, 12))
            kcsd_est = kc.values()
            metrics[f"{name}_kcsd_seconds"] = _time.process_time() - t0
        truth_kcsd = normalize(csd_true_f(kc.estm_x, t))
        metrics[f"{name}_kcsd_mse"] = float(mse(normalize(kcsd_est), truth_kcsd))
        preds[name] = (model, est)

    if results_dir:
        figures.draw(figures.simple_template_1d_figure, "simple_template_1d.png", z, t, x,
                     csd_true, lfp_noisy, preds, results_dir)
    report("simple_template_1d", metrics, results_dir)
    return metrics, preds


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true", help="fewer restarts, coarser grid")
    p.add_argument("--results-dir", default=None)
    p.add_argument("--device", default=config.DEFAULT_DEVICE)
    args = p.parse_args(argv)
    if args.quick:
        run(n_restarts=3, deltaz=50.0, results_dir=args.results_dir, device=args.device)
    else:
        run(results_dir=args.results_dir, device=args.device)


if __name__ == "__main__":
    main()
