"""Configurations of the GPCSD2D family (a planar probe).

``make_data`` is the frozen generator of the cells' data: a plain copy of
``gpcsd_tpu_torch.nuts_2d_probe.build_probe_model`` (an exact draw of the LFP
from the model's marginal law at the labelled truth, signal variance per
channel ``signal_variance`` against ``sig2n``), with its random stream, its
order and its floating-point operations, on the host.  It reads the
covariances from the plain reference and nothing of the program.

``build_program`` builds the program's ``GPCSD2D`` from the configuration
through the public constructors, its priors as the configuration states them,
its parameters at the truth.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from benchmark.configs.gpcsd1d import _cholesky, _priors
from benchmark.reference import gpcsd as ref

F64 = torch.float64


def geometry(cfg):
    """Sites (nx, 2), times (nt,) in ms, the quadrature box and rule (nodes, weights)."""
    cols = np.array(cfg["columns_um"])
    idx = np.arange(cfg["nx"])
    x = np.stack([cols[idx % cols.size], cfg["row_pitch_um"] * (idx // 2)], axis=1)
    t = np.arange(cfg["nt"]) * cfg["dt_ms"]
    p1, p2 = cfg["pad_um"]
    box = (x[:, 0].min() - p1, x[:, 0].max() + p1, x[:, 1].min() - p2, x[:, 1].max() + p2)
    n1, n2 = cfg["ngl"]
    g1, w1 = ref.gauss_legendre(box[0], box[1], n1)
    g2, w2 = ref.gauss_legendre(box[2], box[3], n2)
    gl_xy = ref.expand_grid(g1, g2)
    gl_w = np.prod(ref.expand_grid(w1, w2), axis=1)
    return x, t, box, gl_xy, gl_w


def make_data(cfg, seed):
    """``lfp`` (nx, nt, ntrials), times ``t`` (nt,), sites ``x`` (nx, 2), ``truth``."""
    x, t, _, gl_xy, gl_w = geometry(cfg)
    tr = cfg["truth"]
    th = {k: torch.tensor(tr[k], dtype=F64) for k in ("R", "ell1", "ell2")}
    Ks = ref.Spatial2D(x, gl_xy, gl_w, cfg["eps"], cfg["jitter"], F64, "cpu")(th).numpy()
    c = float(np.mean(np.diag(Ks)))
    s1, s2 = (v / c for v in tr["signal_variance"])
    th_t = {"tm0_ell": torch.tensor(tr["tm0_ell"], dtype=F64), "tm0_sigma2": torch.tensor(s1, dtype=F64),
            "tm1_ell": torch.tensor(tr["tm1_ell"], dtype=F64), "tm1_sigma2": torch.tensor(s2, dtype=F64)}
    Kt = ref.temporal_cov(cfg["temporal"], th_t, torch.as_tensor(t)).numpy()
    Ls, Lt = _cholesky(Ks), _cholesky(Kt)
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(cfg["ntrials"], Ks.shape[0], Kt.shape[0]))
    lfp = np.ascontiguousarray(np.moveaxis(Ls @ z @ Lt.T, 0, 2))
    lfp += np.sqrt(tr["sig2n"]) * rng.normal(size=lfp.shape)
    truth = {"R": tr["R"], "ell1": tr["ell1"], "ell2": tr["ell2"], "tm0_ell": tr["tm0_ell"],
             "tm0_sigma2": s1, "tm1_ell": tr["tm1_ell"], "tm1_sigma2": s2, "sig2n": tr["sig2n"]}
    return SimpleNamespace(lfp=lfp, t=t, x=x, truth=truth)


def build_program(cfg, data, device):
    """The program's ``GPCSD2D`` on ``device``, parameters at the truth."""
    import gpcsd_tpu_torch as P

    pr = _priors(cfg)
    _, _, box, _, _ = geometry(cfg)
    x, t = data.x, data.t.reshape(-1, 1)
    n1, n2 = cfg["ngl"]
    kinds = {"se": P.GPCSDTemporalCovSE, "matern": P.GPCSDTemporalCovMatern}
    temporal = [kinds[k](t, ell_prior=pr[f"tm{i}_ell"], sigma2_prior=pr[f"tm{i}_sigma2"])
                for i, k in enumerate(cfg["temporal"])]
    spatial = P.GPCSD2DSpatialCovSE(x, ell_prior1=pr["ell1"], ell_prior2=pr["ell2"],
                                    a1=box[0], b1=box[1], a2=box[2], b2=box[3], ngl1=n1, ngl2=n2)
    m = P.GPCSD2D(data.lfp, x, t, a1=box[0], b1=box[1], a2=box[2], b2=box[3], ngl1=n1, ngl2=n2,
                  spatial_cov=spatial, temporal_cov_list=temporal, R_prior=pr["R"],
                  sig2n_prior=pr["sig2n"], eps=cfg["eps"], het_noise=cfg["het_noise"],
                  device=device)
    tr = data.truth
    m.R["value"] = tr["R"]
    spatial.params["ell1"]["value"] = tr["ell1"]
    spatial.params["ell2"]["value"] = tr["ell2"]
    for i, tc in enumerate(temporal):
        tc.params["ell"]["value"] = tr[f"tm{i}_ell"]
        tc.params["sigma2"]["value"] = tr[f"tm{i}_sigma2"]
    m.sig2n["value"] = tr["sig2n"]
    return m


def reference_problem(cfg, data, dtype, device):
    """The plain reference's :class:`~benchmark.reference.gpcsd.Problem` of ``data``."""
    _, _, _, gl_xy, gl_w = geometry(cfg)
    spatial = ref.Spatial2D(data.x, gl_xy, gl_w, cfg["eps"], cfg["jitter"], dtype, device)
    return ref.Problem(cfg["params"], spatial, cfg["temporal"], data.t,
                       np.moveaxis(data.lfp, 2, 0), dtype, device)
