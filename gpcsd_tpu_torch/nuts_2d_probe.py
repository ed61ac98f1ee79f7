"""NUTS on the 2D model at the Neuropixels width.

Counterpart of ``scripts/nuts_2d_probe.py``: GPCSD2D at nx=69 channels,
nt=375, 100 trials and a 30 x 120 quadrature rule
(:func:`gpcsd_tpu_torch.paper.neuropixels_problem`), on LFP drawn from the
model family (:func:`build_probe_model`), sampled by resumable NUTS through
``sample_posterior`` from the generating parameters, whitened by the float64
Laplace Hessian there.  The JAX script's purpose is kept: the viability and
throughput of 2D NUTS on the device, not a converged posterior.

Every stage is cached in ``--out-dir``: the surrogate
(``surrogate_lfp_2d.npz``, with the seed and sizes it was made with; another
seed or size makes it anew, with a warning), the Hessian
(``hessian_f64_2d.npz``: ``H``, ``u0``, seed; taken on the model's device,
since the port is float64 on the card), the sampler's state (``nuts_state``,
every 5 transitions) and the seconds of every transition
(``chunk_timing.json``).  ``--prep-only`` writes the first two and exits 0;
with ``--max-seconds`` the process exits 3 at the first saved transition
past that much time since it started, and a rerun continues from there:

    until python3 scripts/torch_nuts_2d_probe.py --dense-mass --max-seconds 1200; do :; done

A finished run leaves ``nuts_2d_probe.json`` (the JAX script's fields, plus
``device``, ``nvidia_smi``, ``healthy``, ``gate_failures`` and
``median_sampling_transition_s``; its rate is null whenever
:func:`gpcsd_tpu_torch.bench.artifact_gate_failures` finds a fault) and
``posterior_samples_2d.npz``.  The size flags (``--nt``, ``--ntrials``,
``--ngl1``, ``--ngl2``) exist for small runs on the CPU.

Not carried over: ``--chunk`` (a chunk is one transition here) and the
Hessian's CPU subprocess.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import warnings

import numpy as np
import torch

from . import config, paper
from .bench import artifact_gate_failures
from .models.inference_api import laplace_hessian
from .paper_run import _replace_with
from .utils.profiling import _sync, nvidia_smi

SAVE_EVERY = 5
#: step of the Hessian's central differences (the JAX prep's)
HESSIAN_H = 1e-4


class _TimeBudget(Exception):
    pass


def build_probe_model(out_dir, seed, nt=paper.NP_NT, ntrials=paper.NP_NTRIALS,
                      ngl1=paper.NP_NGL1, ngl2=paper.NP_NGL2, device=config.DEFAULT_DEVICE):
    """The Neuropixels problem with MODEL-FAMILY surrogate data, cached in
    ``out_dir``.

    A sampler probe on pure-noise data is degenerate (~1 leapfrog a draw,
    VERDICT r3 weak #1), so the LFP is a prior Kronecker draw through the
    model's own 2D quadrature LFP covariance at the paper run's SNR (signal
    variance ~0.5 against sig2n 0.01).  The stream and its order are the
    JAX script's: ``numpy.random.default_rng(seed)``, ``z`` of shape
    (ntrials, nx, nt), then the noise; its trial einsum is replaced by
    matmuls.  Ks and Kt are built on ``device``, the Cholesky factors in
    numpy.
    """
    m = paper.neuropixels_problem(seed, nt=nt, ntrials=ntrials, ngl1=ngl1, ngl2=ngl2,
                                  device=device)
    made_with = {"seed": seed, "nt": nt, "ntrials": ntrials, "ngl1": ngl1, "ngl2": ngl2}
    data_path = os.path.join(out_dir, "surrogate_lfp_2d.npz")
    data = None
    if os.path.exists(data_path):
        with np.load(data_path) as d:
            cached = {k: int(d[k]) if k in d.files else None for k in made_with}
            if cached == made_with:
                data = {k: d[k] for k in ("lfp", "s1", "s2", "sig2n")}
        if data is None:
            warnings.warn(f"{data_path} was made with {cached}, not {made_with}: "
                          "drawing it anew")
    if data is None:
        rng = np.random.default_rng(seed)
        fns = m._fns()
        with torch.no_grad():
            Ks = fns.build_ks(m._theta()).cpu().numpy()
        c = float(np.mean(np.diag(Ks)))
        s1, s2, sig2n = 0.35 / c, 0.15 / c, 0.01
        m.temporal_cov_list[0].params["sigma2"]["value"] = s1
        m.temporal_cov_list[1].params["sigma2"]["value"] = s2
        m.sig2n["value"] = sig2n
        with torch.no_grad():
            Kt = fns.build_kt(m._theta()).cpu().numpy()
        nx, nt_ = Ks.shape[0], Kt.shape[0]
        Ls = np.linalg.cholesky(Ks + 1e-10 * np.trace(Ks) / nx * np.eye(nx))
        Lt = np.linalg.cholesky(Kt + 1e-10 * np.trace(Kt) / nt_ * np.eye(nt_))
        z = rng.normal(size=(ntrials, nx, nt_))
        lfp = np.ascontiguousarray(np.moveaxis(Ls @ z @ Lt.T, 0, 2))  # (nx, nt, ntrials)
        lfp += np.sqrt(sig2n) * rng.normal(size=lfp.shape)
        data = {"lfp": lfp, "s1": s1, "s2": s2, "sig2n": sig2n}
        _replace_with(data_path, lambda f: np.savez(f, **data, **made_with))
    m.temporal_cov_list[0].params["sigma2"]["value"] = float(data["s1"])
    m.temporal_cov_list[1].params["sigma2"]["value"] = float(data["s2"])
    m.sig2n["value"] = float(data["sig2n"])
    m.lfp = data["lfp"]
    return m


def probe_hessian(model, out_dir, seed) -> str:
    """Path of ``hessian_f64_2d.npz`` in ``out_dir``: the float64 Hessian of
    the negative log joint at ``model``'s parameters (central differences of
    the gradient, h = 1e-4, on the model's device), made unless the file
    holds one for the same point and seed."""
    path = os.path.join(out_dir, "hessian_f64_2d.npz")
    u0 = model._fns().param_set.pack(model._theta()).cpu().numpy()
    if os.path.exists(path):
        with np.load(path) as d:
            if int(d["seed"]) == seed and np.array_equal(d["u0"], u0):
                return path
        warnings.warn(f"{path} is of another point or seed: taking the Hessian anew")
    H = laplace_hessian(model._fns(), u0, model._Y(), h=HESSIAN_H)
    _replace_with(path, lambda f: np.savez(f, H=H, u0=u0, seed=seed))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="results/torch_nuts_2d")
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--samples", type=int, default=20)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="exit 3 at the first saved transition after this much wall time "
                         "since the process started; rerun to continue")
    ap.add_argument("--dense-mass", action="store_true",
                    help="full-covariance warmup metric (Stan dense_e)")
    ap.add_argument("--pool-warmup", action="store_true",
                    help="share metric-adaptation statistics across chains")
    ap.add_argument("--reparam", default=None, choices=["amplitude"],
                    help="amplitude reparameterization (models/reparam.py)")
    ap.add_argument("--prep-only", action="store_true",
                    help="write the surrogate and the float64 Hessian, then exit")
    ap.add_argument("--device", default=config.DEFAULT_DEVICE,
                    help="where the model runs (the card unless 'cpu' is asked for)")
    ap.add_argument("--nt", type=int, default=paper.NP_NT)
    ap.add_argument("--ntrials", type=int, default=paper.NP_NTRIALS)
    ap.add_argument("--ngl1", type=int, default=paper.NP_NGL1)
    ap.add_argument("--ngl2", type=int, default=paper.NP_NGL2)
    args = ap.parse_args(argv)
    t0_process = time.time()
    device = config.get_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    out = lambda name: os.path.join(args.out_dir, name)  # noqa: E731

    m = build_probe_model(args.out_dir, args.seed, args.nt, args.ntrials, args.ngl1,
                          args.ngl2, device)
    hess_path = probe_hessian(m, args.out_dir, args.seed)
    if args.prep_only:
        print("prep done (surrogate + f64 Hessian cached)", flush=True)
        return 0

    timing = {}
    if os.path.exists(out("chunk_timing.json")):
        with open(out("chunk_timing.json")) as f:
            timing = json.load(f)
    last = {"t": time.time()}
    total = args.warmup + args.samples

    def cb(i, carry):
        _sync()
        now = time.time()
        timing[str(i)] = now - last["t"]
        last["t"] = now
        _replace_with(out("chunk_timing.json"), lambda f: json.dump(timing, f), "w")
        print(f"transition {i}: {timing[str(i)]:.2f} s", flush=True)
        # the sampler saves BEFORE the callback: a stop here loses nothing
        if (args.max_seconds is not None and now - t0_process > args.max_seconds
                and (i + 1) % SAVE_EVERY == 0 and i + 1 < total):
            raise _TimeBudget

    try:
        post = m.sample_posterior(
            n_chains=args.chains, num_warmup=args.warmup, num_samples=args.samples,
            seed=args.seed, max_depth=args.max_depth, state_path=out("nuts_state"),
            save_every=SAVE_EVERY, callback=cb, laplace_hessian=hess_path,
            dense_mass=args.dense_mass, pool_warmup=args.pool_warmup, reparam=args.reparam,
        )
    except _TimeBudget:
        print("time budget reached: saved; rerun to continue", flush=True)
        return 3

    samp = [v for k, v in timing.items() if int(k) >= args.warmup]
    med = float(np.median(samp)) if samp else None
    d = post.diagnostics
    result = {
        "config": {
            "nx": m.x.shape[0], "nt": args.nt, "ntrials": args.ntrials,
            "ngl": [args.ngl1, args.ngl2], "chains": args.chains, "warmup": args.warmup,
            "samples": args.samples, "max_depth": args.max_depth, "chunk_size": 1,
            "metric": (("dense_mass + " if args.dense_mass else "") + "map-hessian whitening"
                       + (" + amplitude-reparam" if args.reparam else "")),
        },
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "nvidia_smi": nvidia_smi() if device.type == "cuda" else None,
        "samples_per_s_per_chip_median": args.chains / med if med else None,
        "median_sampling_chunk_s": med,
        "median_sampling_transition_s": med,
        "mean_leapfrogs_per_sample": float(d["num_steps"].mean()),
        "mean_acceptance": float(d["accept_prob"].mean()),
        "divergences": int(d["diverging"].sum()),
        "max_rhat": max(float(v) for v in d["rhat"].values()) if d.get("rhat") else None,
        "min_ess": min(float(v) for v in d["ess"].values()) if d.get("ess") else None,
        "min_ess_tail": (min(float(v) for v in d["ess_tail"].values())
                         if d.get("ess_tail") else None),
        "step_size": d["step_size"].tolist(),
    }
    result["gate_failures"] = artifact_gate_failures(result)
    result["healthy"] = not result["gate_failures"]
    if not result["healthy"]:
        result["samples_per_s_per_chip_median"] = None
    _replace_with(out("nuts_2d_probe.json"), lambda f: json.dump(result, f, indent=1), "w")
    _replace_with(out("posterior_samples_2d.npz"), lambda f: np.savez(
        f, raw_u=post.raw.samples.cpu().numpy(), diag_num_steps=d["num_steps"],
        diag_diverging=d["diverging"], diag_step_size=d["step_size"]))
    print(json.dumps({k: result[k] for k in (
        "samples_per_s_per_chip_median", "median_sampling_transition_s",
        "mean_leapfrogs_per_sample", "mean_acceptance", "divergences", "max_rhat", "healthy",
        "gate_failures")}), flush=True)
    print(f"DONE -> {out('nuts_2d_probe.json')}", flush=True)
    return 0
