"""The configurations the port is measured at: the auditory paper model with
its in-family surrogate data, and the Neuropixels 2D problem.

Counterpart of ``scripts/paper_nuts_run.py`` (``paper_surrogate``,
``build_model``) with the auditory workload's constants
(``workloads/auditory_lfp.py``): GPCSD1D with nx=24 electrodes over
[0, 2300] um, 1 kHz sampling, quadrature over [-200, 2600] um at ngl=100,
SE + Matern-1/2 temporal components and 24 per-channel noise variances.
The baseline window (t < 0) of a 1200-sample surrogate is nt=600.

:func:`neuropixels_problem` is the port's copy of ``scripts/bench_2d.py``
(``build_problem``): GPCSD2D at the Neuropixels shape.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .models.covariances import (
    GPCSD1DSpatialCovSE,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
)
from .models.gpcsd1d import GPCSD1D
from .models.gpcsd2d import GPCSD2D
from .models.priors import HalfNormal, InvGamma

FS = 1000.0  # Hz
A, B = 0.0, 2300.0  # electrode span, um
NX = 24
QUAD_A, QUAD_B = -200.0, 2600.0  # quadrature domain, um


def paper_surrogate(seed, ntime, ntrials, device=config.DEFAULT_DEVICE):
    """Exact draw from the GPCSD1D marginal LFP law at the labeled truth.

    The covariance is ``Ks (x) Kt + sig2n I`` with Ks the model's own
    GL-quadrature spatial covariance, and the temporal sigma2 labels are
    calibrated through its gain (``tr Ks / nx``) so the mean per-channel
    signal variance is 0.35 + 0.15 against noise 0.01.  Ks and Kt are built
    by this package on ``device``; the Cholesky factors, the random stream
    (``numpy.random.default_rng(seed)``) and its order are those of the JAX
    package's generator, whose trial einsum is replaced by matmuls.

    :return: ``(lfp (NX, ntime, ntrials), time_ms (ntime,), truth dict)``
    """
    rng = np.random.default_rng(seed)
    x = np.linspace(A, B, NX).reshape(-1, 1)
    time_ms = (np.arange(ntime) - ntime // 2) / FS * 1000.0
    t = time_ms.reshape(-1, 1)
    gen = GPCSD1D(
        np.zeros((NX, ntime, 1)), x, t, a=QUAD_A, b=QUAD_B,
        spatial_cov=GPCSD1DSpatialCovSE(x, a=QUAD_A, b=QUAD_B),
        temporal_cov_list=[GPCSDTemporalCovSE(t), GPCSDTemporalCovMatern(t)],
        device=device,
    )
    gen.R["value"] = 150.0
    gen.spatial_cov.params["ell"]["value"] = 300.0
    gen.temporal_cov_list[0].params["ell"]["value"] = 40.0  # SE, ms
    gen.temporal_cov_list[1].params["ell"]["value"] = 5.0  # Matern, ms
    fns = gen._fns()
    with torch.no_grad():
        Ks = fns.build_ks(gen._theta()).cpu().numpy()
        gain = float(np.trace(Ks) / Ks.shape[0])  # LFP var per unit sigma2
        s0, s1, sig2n = 0.35 / gain, 0.15 / gain, 0.01
        gen.temporal_cov_list[0].params["sigma2"]["value"] = s0
        gen.temporal_cov_list[1].params["sigma2"]["value"] = s1
        Kt = fns.build_kt(gen._theta()).cpu().numpy()
    nx, nt = Ks.shape[0], Kt.shape[0]
    Ls = np.linalg.cholesky(Ks + 1e-10 * np.trace(Ks) / nx * np.eye(nx))
    Lt = np.linalg.cholesky(Kt + 1e-10 * np.trace(Kt) / nt * np.eye(nt))
    z = rng.standard_normal((ntrials, nx, nt))
    lfp = np.ascontiguousarray(np.moveaxis(Ls @ z @ Lt.T, 0, 2))  # (nx, nt, ntrials)
    lfp += np.sqrt(sig2n) * rng.standard_normal(lfp.shape)
    truth = {
        "R": 150.0, "ell": 300.0, "tm0_ell": 40.0, "tm0_sigma2": s0,
        "tm1_ell": 5.0, "tm1_sigma2": s1, "sig2n": sig2n,
    }
    return lfp, time_ms, truth


def build_model(lfp, time_ms, het_noise="approx", device=config.DEFAULT_DEVICE):
    """The paper model on the baseline window (t < 0) of ``lfp``: the
    covariance stack and priors of ``scripts/paper_nuts_run.build_model``
    (reference ``auditory_lfp/fit_gpcsd_baseline.py:80-100``)."""
    base = time_ms < 0
    t = time_ms[base].reshape(-1, 1)
    x = np.linspace(A, B, NX).reshape(-1, 1)
    matern = GPCSDTemporalCovMatern(t)
    matern.params["ell"]["prior"] = InvGamma.from_interval(1.0, 20.0)
    se = GPCSDTemporalCovSE(t)
    se.params["ell"]["prior"] = InvGamma.from_interval(30.0, 100.0)
    return GPCSD1D(
        lfp[:, base, :], x, t, a=QUAD_A, b=QUAD_B,
        spatial_cov=GPCSD1DSpatialCovSE(x, a=QUAD_A, b=QUAD_B),
        temporal_cov_list=[se, matern],
        sig2n_prior=[HalfNormal(0.1) for _ in range(NX)],
        het_noise=het_noise,
        device=device,
    )


#: the Neuropixels 2D problem: 150 ms at 2.5 kHz, 100 trials, 30 x 120 nodes
NP_NT, NP_NTRIALS = 375, 100
NP_NGL1, NP_NGL2 = 30, 120


def neuropixels_geometry():
    """(69, 2) electrode sites of the staggered 4-column Neuropixels layout:
    2 channels per 20 um row (reference ``neuropixels/extract_data.py:20-42``
    channel -> (x, y) map)."""
    cols = np.array([16.0, 48.0, 0.0, 32.0])
    idx = np.arange(69)
    return np.stack([cols[idx % 4], 20.0 * (idx // 2)], axis=1)


def neuropixels_problem(seed=0, nt=NP_NT, ntrials=NP_NTRIALS, ngl1=NP_NGL1, ngl2=NP_NGL2,
                        device=config.DEFAULT_DEVICE):
    """GPCSD2D at the Neuropixels shape: nx=69, nt=375 (150 ms at 2.5 kHz),
    100 trials of white-noise LFP from ``numpy.random.default_rng(seed)``,
    a 30 x 120 quadrature rule on the domain padded by 16 um and 100 um as
    in the reference fit (``fit_gpcsd2d.py:88-90``), ``eps=1``, SE +
    Matern-1/2, scalar noise (8 parameters), at fixed parameter values.
    The size arguments exist for small test problems on the same geometry."""
    rng = np.random.default_rng(seed)
    x = neuropixels_geometry()
    t = np.arange(nt).reshape(-1, 1) * 0.4
    lfp = rng.normal(size=(x.shape[0], nt, ntrials))
    m = GPCSD2D(lfp, x, t, ngl1=ngl1, ngl2=ngl2, eps=1.0,
                a1=x[:, 0].min() - 16.0, b1=x[:, 0].max() + 16.0,
                a2=x[:, 1].min() - 100.0, b2=x[:, 1].max() + 100.0, device=device)
    m.R["value"] = 100.0
    m.spatial_cov.params["ell1"]["value"] = 40.0
    m.spatial_cov.params["ell2"]["value"] = 150.0
    m.temporal_cov_list[0].params["ell"]["value"] = 10.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    m.temporal_cov_list[1].params["ell"]["value"] = 2.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
    m.sig2n["value"] = 0.1
    return m
