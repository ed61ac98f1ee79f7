"""Posterior-moment accuracy gate of the PyTorch port: a run of the port's
paper sampler against a control run of the same posterior, twin of
``scripts/posterior_accuracy.py`` on the port's
:func:`gpcsd_tpu_torch.infer.diagnostics.ess_bulk` (numpy; no JAX).

Per shared parameter it records

    z = |mean_run - mean_control| / sqrt(sd_run^2/ess_run + sd_control^2/ess_control)

(the combined Monte-Carlo standard error, each side's MCSE from its
rank-normalized bulk ESS, on the unconstrained draws) and the gate
``max |z| < z_max``; the exit code is 0 when the gate passes and 1 when it
fails.  It also reports the run's truth-coverage z-scores
``(mean - truth) / posterior_sd`` for the surrogate's known
hyperparameters, from the artifact's constrained summaries: those measure
how far the truth sits within the posterior, not numerical agreement, and
gate nothing.

Each run directory holds the two artifacts that the paper-run scripts write:
``paper_nuts_auditory.json`` and ``posterior_samples.npz`` (``raw_u``,
(chains, draws, dim)).  From the repository root:

    python3 scripts/torch_posterior_accuracy.py \\
        --run results/torch_paper_nuts_hetx --control results/paper_nuts_hetx
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpcsd_tpu_torch.infer.diagnostics import ess_bulk  # noqa: E402

DEFAULT_OUT = "results/torch_posterior_accuracy/acceptance.json"


def load_run(run_dir):
    """(artifact dict, raw unconstrained draws (chains, draws, dim))."""
    with open(os.path.join(run_dir, "paper_nuts_auditory.json")) as f:
        art = json.load(f)
    with np.load(os.path.join(run_dir, "posterior_samples.npz")) as d:
        u = np.asarray(d["raw_u"], dtype=np.float64)
    return art, u


def moments(u, names):
    """Per-parameter (mean, sd, bulk ESS) from unconstrained draws."""
    flat = u.reshape(-1, u.shape[-1])
    eb = ess_bulk(u)
    return {n: {"mean": float(flat[:, i].mean()), "sd": float(flat[:, i].std(ddof=1)),
                "ess": float(eb[i])}
            for i, n in enumerate(names)}


def mcse_z(m_run, m_control):
    """Per parameter, the difference of the means over their combined MCSE
    (0 where both MCSEs are 0)."""
    z = {}
    for n, a in m_run.items():
        b = m_control[n]
        mcse = np.sqrt(a["sd"] ** 2 / a["ess"] + b["sd"] ** 2 / b["ess"])
        z[n] = float(abs(a["mean"] - b["mean"]) / mcse) if mcse > 0 else 0.0
    return z


def truth_coverage(art):
    """Per hyperparameter with a known truth, ``(posterior mean - truth) /
    posterior sd`` in constrained space, from the artifact's summaries."""
    coverage = {}
    for k, tv in art.get("truth", {}).items():
        pm = art.get("posterior_mean", {}).get(k)
        ps = art.get("posterior_sd", {}).get(k)
        if pm is None or ps is None:
            continue
        pm, ps, tv = np.atleast_1d(pm), np.atleast_1d(ps), np.atleast_1d(tv)
        with np.errstate(divide="ignore", invalid="ignore"):
            zz = (pm - tv) / np.where(ps > 0, ps, np.nan)
        coverage[k] = [float(v) for v in np.atleast_1d(zz)]
    return coverage


def _health(art):
    return {k: art.get(k) for k in ("max_rhat", "min_ess", "divergences")}


def accuracy(run_dir, control_dir, z_max=3.0):
    """The gate's record: z per parameter, ``max_z``, ``pass``, both runs'
    moments and health, and the run's truth coverage."""
    art_r, u_r = load_run(run_dir)
    art_c, u_c = load_run(control_dir)
    names = list(art_r.get("rhat", {}).keys())
    if not len(names) == u_r.shape[-1] == u_c.shape[-1]:
        raise ValueError(f"{len(names)} parameter names, draws of {u_r.shape} and {u_c.shape}")
    m_r, m_c = moments(u_r, names), moments(u_c, names)
    z = mcse_z(m_r, m_c)
    max_z = max(z.values())
    return {
        "run": run_dir,
        "control": control_dir,
        # the port's artifacts name their device, the JAX scripts' their backend
        "run_device": art_r.get("device", art_r.get("backend")),
        "control_device": art_c.get("device", art_c.get("backend")),
        "run_health": _health(art_r),
        "control_health": _health(art_c),
        "z_scores_u_space": z,
        "max_z": max_z,
        "argmax_z": max(z, key=z.get),
        "z_max_gate": z_max,
        "pass": bool(max_z < z_max),
        "run_moments_u": m_r,
        "control_moments_u": m_c,
        "truth_coverage_z": truth_coverage(art_r),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", default="results/torch_paper_nuts_hetx",
                    help="the accelerator run's directory")
    ap.add_argument("--control", default="results/paper_nuts_hetx",
                    help="the control run's directory")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--z-max", type=float, default=3.0)
    args = ap.parse_args(argv)

    result = accuracy(args.run, args.control, args.z_max)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out + ".tmp", "w") as f:
        json.dump(result, f, indent=1)
    os.replace(args.out + ".tmp", args.out)
    print(json.dumps({"max_z": result["max_z"], "argmax_z": result["argmax_z"],
                      "pass": result["pass"], "out": args.out}))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
