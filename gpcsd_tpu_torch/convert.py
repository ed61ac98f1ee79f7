"""Carry parameter values and sampler state across from the JAX package
(as numpy).

Both schemas of ``gpcsd_tpu``'s models are accepted: the flat-named theta
of ``_theta()`` (``R``, ``ell`` or ``ell1``/``ell2``, ``tm{i}_ell``,
``tm{i}_sigma2``, ``sig2n``) and the reference-style dict of
``extract_model_params()`` (``R``, ``sig2n``, ``spatial_ell`` or
``spatial_ell1``/``spatial_ell2`` with ``eps``, ``temporal_ell_list``,
``temporal_sigma2_list``).  Values may be numpy arrays or floats, so no
JAX type crosses into this package.  Sampler state crosses the same way:
:func:`nuts_result_from_numpy` takes the fields of a JAX ``NUTSResult`` or
the arrays of a banked ``posterior_samples.npz``,
:func:`advi_result_from_numpy` and :func:`smc_result_from_numpy` those of
the other two engines' results, and :func:`hessian_from_numpy` a Laplace
Hessian, so that both packages can be fed the same centre, Hessian and
metric.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .config import DTYPE
from .infer.advi import ADVIResult
from .infer.nuts import NUTSResult
from .infer.smc import SMCResult
from .models.gpcsd1d import GPCSD1D
from .models.gpcsd2d import GPCSD2D
from .models.inference_api import load_hessian


def _as_theta_schema(d) -> dict:
    if "temporal_ell_list" not in d:
        return dict(d)
    theta = {"R": d["R"]}
    for flat, ref in (("ell", "spatial_ell"), ("ell1", "spatial_ell1"), ("ell2", "spatial_ell2")):
        if ref in d:
            theta[flat] = d[ref]
    for i, (ell, s2) in enumerate(zip(d["temporal_ell_list"], d["temporal_sigma2_list"])):
        theta[f"tm{i}_ell"] = ell
        theta[f"tm{i}_sigma2"] = s2
    theta["sig2n"] = d["sig2n"]
    return theta


def theta_from_numpy(d, device=config.DEFAULT_DEVICE) -> dict:
    """Flat-named theta of float64 tensors on ``device`` (copies) from
    either schema."""
    device = config.get_device(device)
    return {
        k: torch.tensor(np.asarray(v, dtype=np.float64), dtype=DTYPE, device=device)
        for k, v in _as_theta_schema(d).items()
    }


def _restore(m, params, spatial):
    """Write ``params`` (either schema) into model ``m``; ``spatial`` maps
    the reference-schema names of its spatial lengthscales to flat ones."""
    theta = _as_theta_schema(params)
    n = len(m.temporal_cov_list)
    out = {ref: float(theta[flat]) for ref, flat in spatial.items()}
    if hasattr(m, "eps"):
        out["eps"] = float(params.get("eps", m.eps))
    m.restore_model_params({
        **out,
        "R": float(theta["R"]),
        "sig2n": np.asarray(theta["sig2n"], dtype=np.float64)
        if np.ndim(theta["sig2n"]) else float(theta["sig2n"]),
        "temporal_ell_list": [float(theta[f"tm{i}_ell"]) for i in range(n)],
        "temporal_sigma2_list": [float(theta[f"tm{i}_sigma2"]) for i in range(n)],
    })
    return m


def model_from_reference_params(lfp, x, t, params, **kw) -> GPCSD1D:
    """A :class:`GPCSD1D` on ``(lfp, x, t)`` whose parameter values are
    ``params`` (either schema); ``kw`` goes to the constructor (priors,
    covariance objects, ``het_noise``, ``device``)."""
    return _restore(GPCSD1D(lfp, x, t, **kw), params, {"spatial_ell": "ell"})


def model2d_from_reference_params(lfp, x, t, params, **kw) -> GPCSD2D:
    """A :class:`GPCSD2D` on ``(lfp, x, t)`` whose parameter values are
    ``params``: the dict of ``GPCSD2D.extract_model_params()`` (its ``eps``
    included) or a flat-named theta (``eps`` then comes from ``kw`` or the
    constructor's default)."""
    if "eps" in params:
        kw = {**kw, "eps": float(params["eps"])}
    return _restore(GPCSD2D(lfp, x, t, **kw), params,
                    {"spatial_ell1": "ell1", "spatial_ell2": "ell2"})


#: names of the sampler's fields in a banked ``posterior_samples.npz``
_BANKED_NAMES = {
    "samples": "raw_u", "num_steps": "diag_num_steps", "diverging": "diag_diverging",
    "step_size": "diag_step_size", "accept_prob": "diag_accept_prob",
    "inv_mass": "diag_inv_mass",
}


def nuts_result_from_numpy(d, device=config.DEFAULT_DEVICE) -> NUTSResult:
    """The port's :class:`NUTSResult` (tensors on ``device``) from a mapping
    of numpy arrays: the fields of a JAX ``NUTSResult`` (``res._asdict()``)
    or an opened ``posterior_samples.npz`` of a paper run (``raw_u``,
    ``logp``, ``diag_num_steps``, ...).  ``samples`` and ``logp`` must be
    there; a field the source does not hold is None."""
    device = config.get_device(device)

    def field(name):
        for key in (name, _BANKED_NAMES.get(name)):
            if key is not None and key in d:
                a = np.asarray(d[key])
                if a.dtype.kind == "f":
                    a = a.astype(np.float64)
                elif a.dtype.kind in "iu":
                    a = a.astype(np.int64)
                return torch.tensor(a, device=device)
        if name in ("samples", "logp"):
            raise KeyError(f"no {name!r} (or {_BANKED_NAMES.get(name)!r}) among {list(d)}")
        return None

    return NUTSResult(*(field(name) for name in NUTSResult._fields))


def _f64(a, device):
    return torch.tensor(np.asarray(a, dtype=np.float64), device=config.get_device(device))


def advi_result_from_numpy(d, device=config.DEFAULT_DEVICE) -> ADVIResult:
    """The port's :class:`ADVIResult` (tensors on ``device``) from the
    fields of a JAX ``ADVIResult`` (``res._asdict()``) as numpy arrays."""
    return ADVIResult(*(_f64(d[name], device) for name in ADVIResult._fields))


def smc_result_from_numpy(d, device=config.DEFAULT_DEVICE) -> SMCResult:
    """The port's :class:`SMCResult` (tensors on ``device``) from the fields
    of a JAX ``SMCResult`` (``res._asdict()``) as numpy arrays; the fields
    only the port records keep their defaults."""
    return SMCResult(
        particles=_f64(d["particles"], device), log_weights=_f64(d["log_weights"], device),
        log_evidence=_f64(d["log_evidence"], device), n_stages=int(d["n_stages"]),
        acceptance=_f64(d["acceptance"], device),
    )


def hessian_from_numpy(H, dim=None) -> np.ndarray:
    """A Laplace Hessian for ``sample_posterior(laplace_hessian=...)`` from
    the other package's array (anything ``np.asarray`` takes) or the path
    of an ``.npz`` with key ``H``: (dim, dim) float64 numpy, checked to be
    square.  ``sample_posterior`` symmetrizes what it is given."""
    return load_hessian(H, dim)
