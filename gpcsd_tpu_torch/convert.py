"""Carry parameter values across from the JAX package (as numpy).

Both schemas of ``gpcsd_tpu``'s GPCSD1D are accepted: the flat-named theta
of ``GPCSD1D._theta()`` (``R``, ``ell``, ``tm{i}_ell``, ``tm{i}_sigma2``,
``sig2n``) and the reference-style dict of ``extract_model_params()``
(``R``, ``sig2n``, ``spatial_ell``, ``temporal_ell_list``,
``temporal_sigma2_list``).  Values may be numpy arrays or floats, so no
JAX type crosses into this package.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DTYPE
from .models.gpcsd1d import GPCSD1D


def _as_theta_schema(d) -> dict:
    if "temporal_ell_list" not in d:
        return dict(d)
    theta = {"R": d["R"], "ell": d["spatial_ell"]}
    for i, (ell, s2) in enumerate(zip(d["temporal_ell_list"], d["temporal_sigma2_list"])):
        theta[f"tm{i}_ell"] = ell
        theta[f"tm{i}_sigma2"] = s2
    theta["sig2n"] = d["sig2n"]
    return theta


def theta_from_numpy(d, device="cpu") -> dict:
    """Flat-named theta of float64 tensors on ``device`` (copies) from
    either schema."""
    return {
        k: torch.tensor(np.asarray(v, dtype=np.float64), dtype=DTYPE, device=device)
        for k, v in _as_theta_schema(d).items()
    }


def model_from_reference_params(lfp, x, t, params, **kw) -> GPCSD1D:
    """A :class:`GPCSD1D` on ``(lfp, x, t)`` whose parameter values are
    ``params`` (either schema); ``kw`` goes to the constructor (priors,
    covariance objects, ``het_noise``, ``device``)."""
    m = GPCSD1D(lfp, x, t, **kw)
    theta = _as_theta_schema(params)
    n = len(m.temporal_cov_list)
    m.restore_model_params({
        "R": float(theta["R"]),
        "sig2n": np.asarray(theta["sig2n"], dtype=np.float64)
        if np.ndim(theta["sig2n"]) else float(theta["sig2n"]),
        "spatial_ell": float(theta["ell"]),
        "temporal_ell_list": [float(theta[f"tm{i}_ell"]) for i in range(n)],
        "temporal_sigma2_list": [float(theta[f"tm{i}_sigma2"]) for i in range(n)],
    })
    return m
