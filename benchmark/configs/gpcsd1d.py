"""Configurations of the GPCSD1D family (a linear laminar probe).

``make_data`` is the frozen generator of the cells' data: a plain copy of
``gpcsd_tpu_torch.paper.paper_surrogate`` (an exact draw of the LFP from the
model's marginal law at the labelled truth, the temporal variances
calibrated through the spatial gain so the mean signal variance per channel
is the configuration's ``signal_variance`` against ``sig2n``), with its random
stream, its order and its floating-point operations, on the host.  It reads
the covariances from the plain reference and nothing of the program.  The
model window is the configuration's ``nt`` samples before t = 0.

``build_program`` builds the program's ``GPCSD1D`` from the configuration
through the public constructors, its priors as the configuration states them,
its parameters at the truth.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference import gpcsd as ref

F64 = torch.float64


def geometry(cfg):
    """Electrode sites (nx,), the surrogate's times (ms), the Gauss-Legendre rule."""
    a, b = cfg["electrodes_um"]
    x = np.linspace(a, b, cfg["nx"])
    ntime = cfg["surrogate_samples"]
    time_ms = (np.arange(ntime) - ntime // 2) / cfg["fs_hz"] * 1000.0
    gl_x, gl_w = ref.gauss_legendre(*cfg["quadrature_um"], cfg["ngl"])
    return x, time_ms, gl_x, gl_w


def _cholesky(K):
    n = K.shape[0]
    return np.linalg.cholesky(K + 1e-10 * np.trace(K) / n * np.eye(n))


def make_data(cfg, seed):
    """``lfp`` (nx, nt, ntrials) of the model window, its times ``t`` (nt,),
    the sites ``x`` and the ``truth`` (name -> constrained value)."""
    rng = np.random.default_rng(seed)
    x, time_ms, gl_x, gl_w = geometry(cfg)
    tr = cfg["truth"]
    th = {"R": torch.tensor(tr["R"], dtype=F64), "ell": torch.tensor(tr["ell"], dtype=F64)}
    Ks = ref.Spatial1D(x, gl_x, gl_w, cfg["jitter"], F64, "cpu")(th).numpy()
    gain = float(np.trace(Ks) / Ks.shape[0])
    s0, s1 = (v / gain for v in tr["signal_variance"])
    th_t = {"tm0_ell": torch.tensor(tr["tm0_ell"], dtype=F64), "tm0_sigma2": torch.tensor(s0, dtype=F64),
            "tm1_ell": torch.tensor(tr["tm1_ell"], dtype=F64), "tm1_sigma2": torch.tensor(s1, dtype=F64)}
    Kt = ref.temporal_cov(cfg["temporal"], th_t, torch.as_tensor(time_ms)).numpy()
    Ls, Lt = _cholesky(Ks), _cholesky(Kt)
    z = rng.standard_normal((cfg["ntrials"], Ks.shape[0], Kt.shape[0]))
    lfp = np.ascontiguousarray(np.moveaxis(Ls @ z @ Lt.T, 0, 2))
    lfp += np.sqrt(tr["sig2n"]) * rng.standard_normal(lfp.shape)
    base = time_ms < 0
    if int(base.sum()) != cfg["nt"]:
        raise ValueError(f"the window holds {int(base.sum())} samples, the configuration says {cfg['nt']}")
    truth = {"R": tr["R"], "ell": tr["ell"], "tm0_ell": tr["tm0_ell"], "tm0_sigma2": s0,
             "tm1_ell": tr["tm1_ell"], "tm1_sigma2": s1, "sig2n": tr["sig2n"]}
    return SimpleNamespace(lfp=np.ascontiguousarray(lfp[:, base, :]), t=time_ms[base], x=x,
                           truth=truth)


def _priors(cfg):
    """The program's prior objects by parameter name; per-channel noise gets
    one per channel."""
    from gpcsd_tpu_torch.models.priors import HalfNormal, InvGamma

    out = {}
    for p in cfg["params"]:
        pr = p["prior"]
        out[p["name"]] = (InvGamma(pr["alpha"], pr["beta"]) if pr["kind"] == "invgamma"
                          else HalfNormal(pr["sd"]))
    if cfg["noise"] == "per_channel":
        out["sig2n"] = [out["sig2n"]] * cfg["nx"]
    return out


def build_program(cfg, data, device):
    """The program's ``GPCSD1D`` on ``device``, parameters at the truth."""
    import gpcsd_tpu_torch as P

    pr = _priors(cfg)
    x, t = data.x.reshape(-1, 1), data.t.reshape(-1, 1)
    qa, qb = cfg["quadrature_um"]
    kinds = {"se": P.GPCSDTemporalCovSE, "matern": P.GPCSDTemporalCovMatern}
    temporal = [kinds[k](t, ell_prior=pr[f"tm{i}_ell"], sigma2_prior=pr[f"tm{i}_sigma2"])
                for i, k in enumerate(cfg["temporal"])]
    spatial = P.GPCSD1DSpatialCovSE(x, ell_prior=pr["ell"], a=qa, b=qb, ngl=cfg["ngl"])
    m = P.GPCSD1D(data.lfp, x, t, a=qa, b=qb, ngl=cfg["ngl"], spatial_cov=spatial,
                  temporal_cov_list=temporal, R_prior=pr["R"], sig2n_prior=pr["sig2n"],
                  het_noise=cfg["het_noise"], device=device)
    tr = data.truth
    m.R["value"] = tr["R"]
    spatial.params["ell"]["value"] = tr["ell"]
    for i, tc in enumerate(temporal):
        tc.params["ell"]["value"] = tr[f"tm{i}_ell"]
        tc.params["sigma2"]["value"] = tr[f"tm{i}_sigma2"]
    m.sig2n["value"] = np.full(cfg["nx"], tr["sig2n"]) if cfg["noise"] == "per_channel" else tr["sig2n"]
    return m


def reference_problem(cfg, data, dtype, device):
    """The plain reference's :class:`~benchmark.reference.gpcsd.Problem` of ``data``."""
    _, _, gl_x, gl_w = geometry(cfg)
    spatial = ref.Spatial1D(data.x, gl_x, gl_w, cfg["jitter"], dtype, device)
    return ref.Problem(cfg["params"], spatial, cfg["temporal"], data.t,
                       np.moveaxis(data.lfp, 2, 0), dtype, device)
