"""Model-mismatch robustness study, twin of ``workloads/sim_from_gp_1d_mismatch.py``
on the PyTorch port.

Parity target: the reference ``simulation_studies/sim_from_gp_1D_mismatch.py``:
generate from a 2-component temporal model and fit a 1-component model
with per-channel noise; generate from 3 components and fit 2; report CSD
recovery MSE under misspecification.  Beyond the reference, as in the JAX
workload: SMC posteriors of the 1- and 2-component stacks ranked by
PSIS-LOO.  SMC stops at 100 stages, as in JAX, so a run may end with its
inverse temperature below 1; the metrics record each run's stages and last
temperature.

Run: ``python -m gpcsd_tpu_torch.workloads.sim_from_gp_1d_mismatch [--quick] [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import config
from ..infer import model_comparison as mc
from ..models.covariances import GPCSDTemporalCovMatern, GPCSDTemporalCovSE
from ..models.gpcsd1d import GPCSD1D
from ..models.priors import HalfNormal
from ..ops.forward import fwd_model_1d
from .common import mse, report, stage


def _temporal_covs(t, n_components):
    covs = [GPCSDTemporalCovSE(t.reshape(-1, 1))]
    if n_components >= 2:
        covs.append(GPCSDTemporalCovMatern(t.reshape(-1, 1)))
    return covs


def _generate(x, t, ntrials, temporal_params, seed, device=config.DEFAULT_DEVICE):
    """Prior CSD draws of a generator with the temporal stack
    ``temporal_params`` (a list of (kind, ell, sigma2)), and their
    normalized LFP plus noise 1e-2; numpy (csd, lfp), (nx, nt, ntrials)."""
    covs = []
    for kind, ell, s2 in temporal_params:
        tc = (GPCSDTemporalCovSE if kind == "se" else GPCSDTemporalCovMatern)(t.reshape(-1, 1))
        tc.params["ell"]["value"] = ell
        tc.params["sigma2"]["value"] = s2
        covs.append(tc)
    gen = GPCSD1D(np.zeros((x.size, t.size, 1)), x.reshape(-1, 1), t.reshape(-1, 1),
                  temporal_cov_list=covs, device=device)
    gen.R["value"] = 100.0
    gen.spatial_cov.params["ell"]["value"] = 200.0
    gen.sig2n["value"] = 1e-4
    csd = gen.sample_prior(ntrials, seed=seed)
    xt = config.on_device(x, device)
    lfp = fwd_model_1d(config.on_device(np.moveaxis(csd, 2, 0), device), xt, xt, 100.0)
    lfp = np.moveaxis(lfp.cpu().numpy(), 0, 2)
    lfp = lfp / np.max(np.abs(lfp))
    rng = np.random.default_rng(seed + 7)
    lfp = lfp + 1e-2 * rng.normal(size=lfp.shape)
    return csd, lfp


def _norm(v):
    return v / np.max(np.abs(v), axis=(0, 1), keepdims=True)


def _fit_and_score(x, t, lfp, csd_true, n_components, n_restarts, per_channel, seed,
                   device=config.DEFAULT_DEVICE):
    """MSE of the fitted model's posterior CSD against the generated CSD,
    each trial normalized."""
    sig2n_prior = [HalfNormal(0.1) for _ in range(x.size)] if per_channel else None
    model = GPCSD1D(lfp, x.reshape(-1, 1), t.reshape(-1, 1),
                    temporal_cov_list=_temporal_covs(t, n_components),
                    sig2n_prior=sig2n_prior, device=device)
    model.fit(n_restarts=n_restarts, seed=seed)
    model.predict(x.reshape(-1, 1), t.reshape(-1, 1))
    return float(mse(_norm(model.csd_pred), _norm(csd_true)))


def _loo_compare(x, t, lfp, seed, n_particles=128, device=config.DEFAULT_DEVICE):
    """Fully-Bayesian stack selection (beyond the reference): SMC posteriors
    for the 1- and 2-component temporal stacks, ranked by PSIS-LOO
    (:mod:`gpcsd_tpu_torch.infer.model_comparison`).  Each run's stages and
    last inverse temperature are in the metrics."""
    ics, smc_info = {}, {}
    for ncomp in (1, 2):
        model = GPCSD1D(lfp, x.reshape(-1, 1), t.reshape(-1, 1),
                        temporal_cov_list=_temporal_covs(t, ncomp), device=device)
        post = model.smc(n_particles=n_particles, n_mutation_steps=4, seed=seed)
        name = "%dcomp" % ncomp
        smc_info[f"smc_stages_{name}"] = int(post.raw.n_stages)
        smc_info[f"smc_final_temperature_{name}"] = float(post.raw.temperatures[-1])
        ics[name] = model.information_criteria(method="loo", max_draws=n_particles)["loo"]
    ranked = mc.compare(ics)
    return {
        "loo_best_stack": ranked[0][0],
        "loo_elpd_1comp": ics["1comp"]["elpd_loo"],
        "loo_elpd_2comp": ics["2comp"]["elpd_loo"],
        "loo_d_elpd_runnerup": ranked[1][2],
        "loo_d_se_runnerup": ranked[1][3],
        "loo_max_pareto_k": float(max(ics[k]["pareto_k"].max() for k in ics)),
        **smc_info,
    }


def run(ntrials=50, nt=50, nx=24, n_restarts=5, seed=11, results_dir=None,
        device=config.DEFAULT_DEVICE, timings=None):
    """The study; returns its metrics.

    :param timings: a dict to which each stage's seconds are added
        (``surrogate``, ``fit``, ``smc_loo``), or None.
    """
    dev = config.get_device(device)
    x = np.linspace(0, 2300, nx)
    t = np.linspace(0, 50, nt)

    with stage(timings, "surrogate", dev):
        # 2-component truth; 3-component truth
        csd2, lfp2 = _generate(x, t, ntrials, [("se", 20.0, 0.5), ("matern", 5.0, 0.7)], seed, dev)
        csd3, lfp3 = _generate(
            x, t, ntrials, [("se", 30.0, 0.4), ("se", 10.0, 0.4), ("matern", 3.0, 0.6)],
            seed + 1, dev,
        )
    with stage(timings, "fit", dev):
        mse_2to1 = _fit_and_score(x, t, lfp2, csd2, 1, n_restarts, True, seed, dev)
        mse_2to2 = _fit_and_score(x, t, lfp2, csd2, 2, n_restarts, False, seed, dev)
        mse_3to2 = _fit_and_score(x, t, lfp3, csd3, 2, n_restarts, False, seed + 1, dev)

    metrics = {
        "mse_2comp_fit1": mse_2to1,
        "mse_2comp_fit2": mse_2to2,
        "mse_3comp_fit2": mse_3to2,
    }
    with stage(timings, "smc_loo", dev):
        metrics.update(_loo_compare(x, t, lfp2, seed, device=dev))
    report("sim_from_gp_1d_mismatch", metrics, results_dir)
    return metrics


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--results-dir", default=None)
    p.add_argument("--device", default=config.DEFAULT_DEVICE)
    args = p.parse_args(argv)
    if args.quick:
        run(ntrials=15, nt=30, n_restarts=2, results_dir=args.results_dir, device=args.device)
    else:
        run(results_dir=args.results_dir, device=args.device)


if __name__ == "__main__":
    main()
