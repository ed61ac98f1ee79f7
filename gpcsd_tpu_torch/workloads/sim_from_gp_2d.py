"""2D simulate-and-recover study, twin of ``workloads/sim_from_gp_2d.py`` on
the PyTorch port.

Parity target: the reference ``simulation_studies/sim_from_gp_2D.py``:
generate CSD from a GPCSD2D prior on a dense 12 x 100 grid, forward-model
to a sparse 4 x 25 electrode grid, add noise; (a) oracle-predict with the
generator's parameters as a sanity check, (b) fit a fresh GPCSD2D (L-BFGS
batched over restarts) and compare CSD recovery (RMSE / R^2) against the
traditional columnwise-CSD baseline.  The prior draw, the forward model,
the fit and both predictions run on the device; the prior draw comes from
numpy's generator, so it is not the JAX workload's array for the same
seed.  With ``results_dir`` set, the JAX workload's figure is drawn
(:func:`gpcsd_tpu_torch.workloads.figures.sim_from_gp_2d_figure`) where
matplotlib imports.

Run: ``python -m gpcsd_tpu_torch.workloads.sim_from_gp_2d [--quick] [--device cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import config
from ..models.covariances import GPCSDTemporalCovMatern, GPCSDTemporalCovSE
from ..models.gpcsd2d import GPCSD2D
from ..models.trad import predictcsd_trad_2d
from ..ops.forward import fwd_model_2d
from ..utils.grids import expand_grid
from . import figures
from .common import mse, r2, report, stage

TRUE = dict(R=30.0, ell1=40.0, ell2=100.0, se_s2=20.0, se_ell=5.0,
            m_s2=10.0, m_ell=1.0, sig2n=0.5, eps=10.0)

A1, B1, A2, B2 = 0.0, 60.0, 0.0, 1000.0


def make_generator(z_grid, t, ngl1, ngl2, device=config.DEFAULT_DEVICE):
    """GPCSD2D at the :data:`TRUE` parameters on the dense grid."""
    gen = GPCSD2D(
        np.zeros((z_grid.shape[0], t.shape[0], 1)), z_grid, t,
        a1=A1, b1=B1, a2=A2, b2=B2, ngl1=ngl1, ngl2=ngl2,
        temporal_cov_list=[GPCSDTemporalCovSE(t), GPCSDTemporalCovMatern(t)],
        eps=TRUE["eps"], device=device,
    )
    gen.R["value"] = TRUE["R"]
    gen.sig2n["value"] = TRUE["sig2n"]
    gen.spatial_cov.params["ell1"]["value"] = TRUE["ell1"]
    gen.spatial_cov.params["ell2"]["value"] = TRUE["ell2"]
    gen.temporal_cov_list[0].params["ell"]["value"] = TRUE["se_ell"]
    gen.temporal_cov_list[0].params["sigma2"]["value"] = TRUE["se_s2"]
    gen.temporal_cov_list[1].params["ell"]["value"] = TRUE["m_ell"]
    gen.temporal_cov_list[1].params["sigma2"]["value"] = TRUE["m_s2"]
    return gen


def run(nt=30, ntrials=3, nz1=12, nz2=100, nx1=4, nx2=25, ngl1=15, ngl2=40,
        n_restarts=5, seed=8, results_dir=None, device=config.DEFAULT_DEVICE, timings=None):
    """The study; returns (metrics, fitted model).

    :param timings: a dict to which each stage's seconds are added
        (``surrogate``, ``oracle``, ``fit``, ``predict``, ``tcsd``), or None.
    """
    dev = config.get_device(device)
    t = np.linspace(0, 20, nt).reshape(-1, 1)
    z1 = np.linspace(A1, B1, nz1)
    z2 = np.linspace(A2, B2, nz2)
    z_grid = expand_grid(z1, z2)
    x_grid = expand_grid(np.linspace(A1, B1, nx1), np.linspace(A2, B2, nx2))

    with stage(timings, "surrogate", dev):
        gen = make_generator(z_grid, t, ngl1, ngl2, dev)
        csd_dense, _ = gen.sample_prior(ntrials, type="csd", seed=seed)
        csd_rect = csd_dense.reshape(nz1, nz2, nt, ntrials)
        lfp = fwd_model_2d(  # (ntrials, nxgrid, nt)
            config.on_device(np.moveaxis(csd_rect, 3, 0), dev),  # (ntrials, nz1, nz2, nt)
            config.on_device(z1, dev), config.on_device(z2, dev), config.on_device(x_grid, dev),
            TRUE["R"], TRUE["eps"],
        )
        lfp = np.moveaxis(lfp.cpu().numpy(), 0, 2)
        rng = np.random.default_rng(seed + 1)
        lfp = lfp + np.sqrt(TRUE["sig2n"]) * rng.normal(size=lfp.shape)

    # oracle prediction from the generator (reference ``sim_from_gp_2D.py:93-98``)
    with stage(timings, "oracle", dev):
        gen.update_lfp(lfp, t, x_grid)
        oracle = gen.predict(z_grid, t, type="csd")

    with stage(timings, "fit", dev):
        model = GPCSD2D(lfp, x_grid, t, a1=A1, b1=B1, a2=A2, b2=B2, ngl1=ngl1, ngl2=ngl2,
                        eps=TRUE["eps"], device=dev)
        model.fit(n_restarts=n_restarts, seed=seed)
    with stage(timings, "predict", dev):
        fitted = model.predict(z_grid, t, type="csd")

    # tCSD on the sparse grid (columns = dim 2)
    with stage(timings, "tcsd", dev):
        tcsd = predictcsd_trad_2d(lfp.reshape(nx1, nx2, nt, ntrials))

    def norm(v):
        return v / np.nanmax(np.abs(v))

    truth_n = norm(csd_dense)
    metrics = {
        "oracle_rmse": float(np.sqrt(mse(norm(oracle), truth_n))),
        "oracle_r2": float(r2(norm(oracle), truth_n)),
        "fitted_rmse": float(np.sqrt(mse(norm(fitted), truth_n))),
        "fitted_r2": float(r2(norm(fitted), truth_n)),
        "fitted_R": float(model.R["value"]),
        "fitted_ell1": float(model.spatial_cov.params["ell1"]["value"]),
        "fitted_ell2": float(model.spatial_cov.params["ell2"]["value"]),
        "tcsd_shape_ok": list(tcsd.shape),
    }
    report("sim_from_gp_2d", metrics, results_dir)
    if results_dir:
        figures.draw(figures.sim_from_gp_2d_figure, "sim_from_gp_2d.png", z1, z2, nz1, nz2, nt,
                     truth_n, norm(oracle), norm(fitted), results_dir)
    return metrics, model


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--results-dir", default=None)
    p.add_argument("--device", default=config.DEFAULT_DEVICE)
    args = p.parse_args(argv)
    if args.quick:
        run(nt=15, nz2=50, nx2=15, ngl1=10, ngl2=25, n_restarts=2,
            results_dir=args.results_dir, device=args.device)
    else:
        run(results_dir=args.results_dir, device=args.device)


if __name__ == "__main__":
    main()
