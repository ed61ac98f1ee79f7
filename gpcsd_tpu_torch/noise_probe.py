"""Small-scale noise of the log-joint at the paper configuration.

Counterpart of ``scripts/f32_noise_probe.py``.  NUTS needs the Hamiltonian
resolved to O(1) log-units: a log-density whose evaluation noise is many
log-units at leapfrog step scales collapses dual averaging's step size.
The probe evaluates ``log p = -neg_log_joint`` at ``npts`` points of a line
segment of half-width ``scale`` through a point ``u0``, along a unit
direction drawn from ``numpy.random.default_rng(seed)``, fits a quadratic
(the density is locally smooth) and reports the RMS residual: the
evaluation noise.  Each point is one unbatched evaluation, as in the JAX
script.

The command line probes the paper run's MAP point: the surrogate and MAP
parameters cached by :mod:`gpcsd_tpu_torch.paper_run` in ``--out-dir``
(``surrogate_lfp.npz``, ``map_params.pkl``), made by its stages when they
are not there.  ``--het-exact`` builds the model with the exact
noise-whitened factorization (the paper run's), else the reference's
approximation.  The JAX script walks a segment in its preconditioned
coordinates; the port has none, so the segment is in the raw
unconstrained ``u``.  Not carried over: the JAX script's precision-policy,
eigensolver and sweep flags, which select TPU workarounds.

    python3 scripts/torch_noise_probe.py [--device cpu] [--het-exact]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from . import config, paper_run
from .utils.profiling import nvidia_smi


def probe(model, u0, scale=1e-2, npts=33, seed=0) -> dict:
    """``log p`` of ``model`` along a line segment through ``u0``.

    :param u0: (dim,) unconstrained point
    :return: dict with the offsets ``ts`` (npts,), the values ``logp``
        (npts,), ``center`` (log p at the middle point), ``range`` (max - min
        over the segment), ``rms`` (standard deviation of the residual of a
        quadratic fit: the evaluation noise) and ``max_abs_residual``
    """
    fns, Y = model._fns(), model._Y()
    u0 = np.asarray(u0, dtype=np.float64)
    du = np.random.default_rng(seed).normal(size=u0.size)
    du /= np.linalg.norm(du)
    ts = np.linspace(-scale, scale, npts)
    us = torch.as_tensor(u0[None, :] + ts[:, None] * du[None, :], device=model.device)
    with torch.no_grad():
        logp = np.array([-float(fns.neg_log_joint(u, Y)) for u in us])
    resid = logp - np.polyval(np.polyfit(ts, logp, 2), ts)
    return {"ts": ts, "logp": logp, "center": float(logp[npts // 2]),
            "range": float(logp.max() - logp.min()), "rms": float(resid.std()),
            "max_abs_residual": float(np.abs(resid).max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="results/torch_paper_nuts_hetx",
                    help="the paper run's directory, whose cached surrogate and MAP are probed")
    ap.add_argument("--scale", type=float, default=1e-2,
                    help="half-width of the segment in unconstrained log-units "
                         "(leapfrog steps move ~1e-2..1e-1)")
    ap.add_argument("--npts", type=int, default=33)
    ap.add_argument("--seed", type=int, default=0, help="seed of the segment's direction")
    ap.add_argument("--device", default=config.DEFAULT_DEVICE,
                    help="where the model runs (the card unless 'cpu' is asked for)")
    ap.add_argument("--het-exact", action="store_true",
                    help="het_noise='exact' (the paper run's) instead of 'approx'")
    args = ap.parse_args(argv)
    device = config.get_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    model = paper_run.build_model(args.out_dir, 1200, 100, 0, device,
                                  het_noise="exact" if args.het_exact else "approx")
    # the MAP is always the paper run's (het_noise="exact"), as in the JAX probe
    exact = model if args.het_exact else paper_run.build_model(args.out_dir, 1200, 100, 0, device)
    paper_run.fit_map(exact, args.out_dir, restarts=10, maxiter=400, seed=0)
    model.restore_model_params(exact.extract_model_params())
    u0 = model._fns().param_set.pack(model._theta()).cpu().numpy()
    res = probe(model, u0, args.scale, args.npts, args.seed)

    card = nvidia_smi() if device.type == "cuda" else None
    print("device: %s (%s)" % (device, card or "no card"))
    print("logp(center) = %.3f" % res["center"])
    print("range over segment = %.3f" % res["range"])
    print("RMS quadratic residual (eval noise) = %.4g log-units" % res["rms"])
    print("max |residual| = %.4g" % res["max_abs_residual"])
    print(json.dumps({"device": str(device), "nvidia_smi": card, "het_noise": model.het_noise,
                      "scale": args.scale, "npts": args.npts,
                      **{k: res[k] for k in ("center", "range", "rms", "max_abs_residual")}}))
    return 0
