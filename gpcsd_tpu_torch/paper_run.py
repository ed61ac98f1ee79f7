"""Paper-scale NUTS posterior run at the auditory configuration.

Counterpart of ``scripts/paper_nuts_run.py`` run as ``--het-exact
--dense-mass --pool-warmup --max-depth 7`` (the configuration of the banked
``results/paper_nuts_hetx`` run), with ``scripts/laplace_hessian.py`` folded
in: GPCSD1D at nx=24, nt=600 (the baseline window of 1200 samples), 100
trials, ngl=100, SE + Matern-1/2, 24 per-channel noise variances with the
exact noise-whitened factorization; MAP fit, unconstrained mode polish,
float64 Laplace Hessian on the model's device, then 4 NUTS chains x (500
warmup + 500 samples) with a dense metric pooled over chains, whitened by
that Hessian.

Every stage is cached in ``--out-dir`` (surrogate data, MAP and mode
parameters, Hessian, sampler state, per-transition timing), so a rerun
continues where the last attempt stopped.  With ``--max-seconds`` the
process ends with exit code 3 once that much time has passed since it
started: inside the MAP stage at its next checkpoint (every 3 L-BFGS
iterations, in ``map_state``), in the sampler at its next saved transition:

    until python scripts/torch_paper_nuts_run.py --max-seconds 1500; do :; done

A finished run exits 0 and leaves ``paper_nuts_auditory.json`` (throughput,
split-R-hat, ESS, divergences, step sizes, truth recovery, the comparison
with the banked posterior) and ``posterior_samples.npz``.

Not carried over from the JAX script: ``--platform``, ``--hessian pooled``,
``--inputs-from``, and the surrogate and Hessian subprocesses.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from . import config, paper
from .bench import artifact_gate_failures
from .infer.diagnostics import ess_bulk
from .infer.lbfgs import LBFGSTimeBudget, lbfgs_minimize
from .io.checkpoint import load_params, save_params
from .models.inference_api import laplace_hessian
from .utils.profiling import nvidia_smi

#: the banked JAX posterior this run is compared with, relative to the
#: repository root
BANKED = os.path.join("results", "paper_nuts_hetx", "posterior_samples.npz")
SAVE_EVERY = 5
#: L-BFGS iterations between two checkpoints of the MAP stage, as the JAX
#: script's ``chunk_iters``
MAP_CHUNK_ITERS = 3
MAX_DEPTH = 7


class _TimeBudget(Exception):
    pass


def _replace_with(path, write, mode="wb"):
    """Write a file through a temporary and ``os.replace``."""
    with open(path + ".tmp", mode) as f:
        write(f)
    os.replace(path + ".tmp", path)


def build_model(out_dir, ntime, ntrials, seed, device, het_noise="exact"):
    """Auditory-size surrogate + the paper covariance stack (the data cached
    on disk so every resume sees the identical problem)."""
    data_path = os.path.join(out_dir, "surrogate_lfp.npz")
    if os.path.exists(data_path):
        with np.load(data_path) as d:
            lfp, time_ms = d["lfp"], d["time_ms"]
    else:
        lfp, time_ms, truth = paper.paper_surrogate(seed, ntime, ntrials, device=device)
        _replace_with(data_path, lambda f: np.savez(
            f, lfp=lfp, time_ms=time_ms, **{"truth_" + k: v for k, v in truth.items()}))
    return paper.build_model(lfp, time_ms, het_noise=het_noise, device=device)


def fit_map(model, out_dir, restarts, maxiter, seed, max_wall_seconds=None):
    """Stage 1: the multi-restart MAP fit of ``model`` (restarts batched on
    its device), written to ``map_params.pkl`` in ``out_dir``, or restored
    from that file when it is there.  The optimizer's state is checkpointed
    in ``map_state`` every :data:`MAP_CHUNK_ITERS` iterations: a fit stopped
    by ``max_wall_seconds`` (:class:`~gpcsd_tpu_torch.infer.lbfgs.LBFGSTimeBudget`)
    continues on the next call, and ends where an uninterrupted fit ends."""
    path = os.path.join(out_dir, "map_params.pkl")
    if os.path.exists(path):
        load_params(model, path)
        print("MAP: restored from cache", flush=True)
        return
    t0 = time.time()
    model.fit(n_restarts=restarts, backend="torch", seed=seed, verbose=True,
              options={"maxiter": maxiter, "chunk_iters": MAP_CHUNK_ITERS,
                       "state_path": os.path.join(out_dir, "map_state"),
                       "max_wall_seconds": max_wall_seconds})
    save_params(model, path + ".tmp")
    os.replace(path + ".tmp", path)
    print(f"MAP: fitted in {time.time() - t0:.1f} s", flush=True)


def polish_mode(model, max_iter):
    """Unconstrained mode polish from the model's (box MAP) parameters.

    The box bounds are the reference's optimizer guard, not part of the
    probability model: the posterior is defined by the priors.  When a bound
    binds at the box MAP, centring and whitening there puts the Laplace
    approximation far from the posterior bulk.  Polishing without the box
    recovers the mode; for well-specified data it is a no-op.  Writes the
    mode into the model and returns it in u.
    """
    fns, Y = model._fns(), model._Y()
    u_map = fns.param_set.pack(model._theta())
    res = lbfgs_minimize(lambda u: fns.neg_log_joint(u, Y), u_map[None], max_iter=max_iter)
    u0 = res.u[0]
    with torch.no_grad():
        f_map = float(fns.neg_log_joint(u_map, Y))
    print("mode polish: logp %+.1f -> %+.1f (gain %.1f), max |du| %.3f, %d iters"
          % (-f_map, -float(res.f[0]), f_map - float(res.f[0]),
             float((u0 - u_map).abs().max()), int(res.n_iter[0])), flush=True)
    model._set_theta(fns.full_theta(fns.param_set.unpack(u0)))
    return u0.cpu().numpy()


def vs_banked(samples_u, names, banked_path):
    """Per parameter, the difference of posterior means in u between this
    run and the banked one over its Monte-Carlo error (each run's sd and
    bulk ESS); None when the banked draws are absent or of another size."""
    if not banked_path or not os.path.exists(banked_path):
        return None
    with np.load(banked_path) as d:
        banked = np.asarray(d["raw_u"], dtype=np.float64)
    if banked.shape[-1] != samples_u.shape[-1]:
        return None
    out = {}
    ess_a, ess_b = ess_bulk(samples_u), ess_bulk(banked)
    a, b = samples_u.reshape(-1, len(names)), banked.reshape(-1, len(names))
    for i, name in enumerate(names):
        mc_err = np.sqrt(a[:, i].var() / ess_a[i] + b[:, i].var() / ess_b[i])
        out[name] = {"z": float((a[:, i].mean() - b[:, i].mean()) / mc_err),
                     "mean": float(a[:, i].mean()), "banked_mean": float(b[:, i].mean()),
                     "mc_error": float(mc_err)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default="results/torch_paper_nuts_hetx")
    ap.add_argument("--ntime", type=int, default=1200)  # 600 pre-stimulus
    ap.add_argument("--ntrials", type=int, default=100)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--max-depth", type=int, default=MAX_DEPTH)
    ap.add_argument("--restarts", type=int, default=10)
    ap.add_argument("--map-maxiter", type=int, default=400)
    ap.add_argument("--polish-maxiter", type=int, default=800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=config.DEFAULT_DEVICE,
                    help="where the model runs (the card unless 'cpu' is asked for)")
    ap.add_argument("--banked", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), BANKED),
        help="posterior_samples.npz of the run to compare with ('' for none)")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="exit 3 at the next MAP checkpoint or saved transition "
                         "after this much wall time since the process started")
    args = ap.parse_args(argv)
    t_process0 = time.time()
    os.makedirs(args.out_dir, exist_ok=True)
    device = config.get_device(args.device)
    out = lambda name: os.path.join(args.out_dir, name)  # noqa: E731

    model = build_model(args.out_dir, args.ntime, args.ntrials, args.seed, device)

    # stage 1: MAP (10 restarts batched on the device); also the polish's start.
    # The budget runs from the process's start, as the sampler's does
    budget = None if args.max_seconds is None else args.max_seconds - (time.time() - t_process0)
    try:
        fit_map(model, args.out_dir, args.restarts, args.map_maxiter, args.seed, budget)
    except LBFGSTimeBudget as e:
        print(f"MAP stage: {e}", flush=True)
        return 3

    # stage 1b: centre sampling at the unconstrained mode, so that the
    # whitening Hessian and the chain inits are consistent
    if os.path.exists(out("mode_params.pkl")):
        load_params(model, out("mode_params.pkl"))
        fns = model._fns()
        u0 = fns.param_set.pack(model._theta()).cpu().numpy()
    else:
        u0 = polish_mode(model, args.polish_maxiter)
        save_params(model, out("mode_params.pkl.tmp"))
        os.replace(out("mode_params.pkl.tmp"), out("mode_params.pkl"))
        # the pickle holds constrained values: recentre on what a rerun reads
        u0 = model._fns().param_set.pack(model._theta()).cpu().numpy()

    # stage 1c: float64 Laplace Hessian at the mode, on the model's device
    cached = False
    if os.path.exists(out("hessian_f64.npz")):
        with np.load(out("hessian_f64.npz")) as d:
            cached = d["u0"].shape == u0.shape and np.allclose(d["u0"], u0)
    if not cached:
        t0 = time.time()
        H = laplace_hessian(model._fns(), u0, model._Y())
        w = np.linalg.eigvalsh(H)
        _replace_with(out("hessian_f64.npz"), lambda f: np.savez(f, H=H, u0=u0, eigs=w))
        print("Laplace Hessian: %.1f s (eig range [%.3e, %.3e], %d non-positive)"
              % (time.time() - t0, w.min(), w.max(), int((w <= 0).sum())), flush=True)

    # stage 2: NUTS with resume + per-transition timing sidecar
    timing = {}
    if os.path.exists(out("chunk_timing.json")):
        with open(out("chunk_timing.json")) as f:
            timing = json.load(f)
    last = {"t": time.time()}
    total = args.warmup + args.samples

    def cb(i, carry):
        now = time.time()
        timing[str(i)] = now - last["t"]
        last["t"] = now
        saved = (i + 1) % SAVE_EVERY == 0 or i + 1 == total
        if saved:
            _replace_with(out("chunk_timing.json"), lambda f: json.dump(timing, f), "w")
            print(f"transition {i}: {timing[str(i)]:.2f} s", flush=True)
        # clean stop at a saved transition: the sampler saves BEFORE the
        # callback, so everything up to transition i is durable here.  The
        # budget runs from the process's start, earlier stages included
        if (args.max_seconds is not None and now - t_process0 > args.max_seconds
                and saved and i + 1 < total):
            raise _TimeBudget

    t_run0 = time.time()
    try:
        post = model.sample_posterior(
            n_chains=args.chains, num_warmup=args.warmup, num_samples=args.samples,
            seed=args.seed, max_depth=args.max_depth, state_path=out("nuts_state"),
            save_every=SAVE_EVERY, callback=cb, laplace_hessian=out("hessian_f64.npz"),
            pool_warmup=True, dense_mass=True,
        )
    except _TimeBudget:
        print(f"time budget reached after {time.time() - t_run0:.0f} s of sampling: "
              "saved; rerun to continue", flush=True)
        return 3
    wall_this_attempt = time.time() - t_run0

    # throughput: median sampling-phase transition, plus the total-wall figure
    samp_durs = [v for k, v in timing.items() if int(k) >= args.warmup]
    warm_durs = [v for k, v in timing.items() if int(k) < args.warmup]
    med = float(np.median(samp_durs)) if samp_durs else None
    diag = post.diagnostics
    per_name = {key: {k: float(v) for k, v in diag.get(key, {}).items()}
                for key in ("rhat", "ess", "ess_tail")}
    rhat, ess, ess_t = per_name["rhat"], per_name["ess"], per_name["ess_tail"]
    smi = nvidia_smi() if device.type == "cuda" else None
    with np.load(out("surrogate_lfp.npz")) as dsur:
        nt = int(np.sum(dsur["time_ms"] < 0))
        truth = {k[len("truth_"):]: float(dsur[k]) for k in dsur.files if k.startswith("truth_")}
    samples_u = post.raw.samples.cpu().numpy()
    names = model._fns().param_set.names_flat()
    result = {
        "config": {
            "nx": paper.NX, "nt": nt, "ntrials": args.ntrials, "ngl": model.ngl,
            "chains": args.chains, "warmup": args.warmup, "samples": args.samples,
            "chunk_size": 1, "max_depth": args.max_depth, "het_noise": model.het_noise,
            "metric": "dense_mass + map-hessian whitening",
        },
        "device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
        "nvidia_smi": smi,
        "samples_per_s_per_chip_median": args.chains / med if med else None,
        "samples_per_s_per_chip_wall": (
            args.chains * args.samples / float(np.sum(samp_durs)) if samp_durs else None),
        "median_sampling_chunk_s": med,
        "median_warmup_chunk_s": float(np.median(warm_durs)) if warm_durs else None,
        "total_chunk_wall_s": float(np.sum(list(timing.values()))),
        "divergences": int(diag["diverging"].sum()),
        "mean_leapfrogs_per_sample": float(diag["num_steps"].mean()),
        "mean_acceptance": float(diag["accept_prob"].mean()),
        "max_rhat": max(rhat.values()) if rhat else None,
        "min_ess": min(ess.values()) if ess else None,
        "min_ess_tail": min(ess_t.values()) if ess_t else None,
        "rhat": rhat, "ess": ess, "ess_tail": ess_t,
        "step_size": diag["step_size"].tolist(),
        "posterior_mean": {k: v.mean(axis=0).tolist() for k, v in post.theta.items()},
        "posterior_sd": {k: v.std(axis=0).tolist() for k, v in post.theta.items()},
        # ground-truth recovery: the surrogate is drawn FROM the model family
        # with known hyperparameters, so the posterior should cover them
        "truth": truth,
        "posterior_quantiles": {
            k: {f"q{int(100 * q):02d}": np.quantile(v, q, axis=0).tolist()
                for q in (0.05, 0.50, 0.95)}
            for k, v in post.theta.items()
        },
        "vs_banked": vs_banked(samples_u, names, args.banked),
    }
    # the one health gate of every posterior artifact; a run that fails it
    # publishes no rate (the median transition stays in median_sampling_chunk_s)
    result["gate_failures"] = artifact_gate_failures(result)
    result["healthy"] = not result["gate_failures"]
    if not result["healthy"]:
        result["samples_per_s_per_chip_median"] = result["samples_per_s_per_chip_wall"] = None
    _replace_with(out("paper_nuts_auditory.json"),
                  lambda f: json.dump(result, f, indent=1), "w")
    # full constrained draws + per-transition diagnostics
    _replace_with(out("posterior_samples.npz"), lambda f: np.savez(
        f, **post.theta, raw_u=samples_u, logp=post.raw.logp.cpu().numpy(),
        diag_num_steps=diag["num_steps"], diag_diverging=diag["diverging"],
        diag_step_size=diag["step_size"], diag_accept_prob=diag["accept_prob"],
        diag_inv_mass=post.raw.inv_mass.cpu().numpy(),
    ))
    zs = result["vs_banked"]
    print(json.dumps({
        **{k: result[k] for k in ("samples_per_s_per_chip_median", "samples_per_s_per_chip_wall",
                                  "divergences", "max_rhat", "min_ess", "healthy")},
        "max_abs_z_vs_banked": max(abs(v["z"]) for v in zs.values()) if zs else None,
    }), flush=True)
    print(f"DONE -> {out('paper_nuts_auditory.json')} (this attempt: {wall_this_attempt:.1f} s)",
          flush=True)
    return 0
