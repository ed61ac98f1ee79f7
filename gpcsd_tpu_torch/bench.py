"""Headline measurements of the port on the card, and the health gate of
every posterior artifact.

Counterpart of ``bench.py`` (:func:`main`, behind ``scripts/torch_bench.py``)
and of ``scripts/bench_2d.py`` (:func:`main_2d`, behind
``scripts/torch_bench_2d.py``).  ``bench.py``'s point is the reference's
flagship fit size (nx=24 electrodes, nt=600, 100 trials, ngl=100, scalar
noise, white-noise LFP); ``scripts/bench_2d.py``'s is the Neuropixels
problem, :func:`gpcsd_tpu_torch.paper.neuropixels_problem`.  :func:`main`
prints ``bench.py``'s two JSON lines with its keys, the log-joint value+grad
evals/s and the health-gated NUTS samples/s, :func:`main_2d`
``bench_2d.py``'s one, each with the card's ``device`` name and
``power_limit`` added and after lines that give the card, the torch version
and every timed repeat.  Neither runs without a card.

Timing: each repeat evaluates the value and gradient of ``neg_log_joint`` at
the same ``n_iters`` distinct points ``u0 + 0.01 N(0, 1)`` (from
``numpy.random.default_rng(1)``, as ``bench.py`` draws them), after a
warm-up; its host clock stops after ``torch.cuda.synchronize()``, and a
pair of CUDA events brackets the same loop.  The figure is the median over
the repeats, with the quartiles beside it.  An event pair measures the
stream's span, idle gaps included.

:func:`artifact_gate_failures` is the one place that decides whether a
posterior artifact may publish a rate; :mod:`gpcsd_tpu_torch.paper_run` and
:mod:`gpcsd_tpu_torch.nuts_2d_probe` record its verdict in theirs.

Not carried over: ``bench_ours(precondition=)`` (the JAX package's
preconditioned Jacobi sweeps, a TPU workaround) and the live run's
``chunk_size`` (the port's sampler has no chunked dispatch: a chunk is one
transition).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import config, paper
from .models.gpcsd1d import GPCSD1D
from .ops.cuda import quadform as qf
from .utils.profiling import _sync, nvidia_smi

NX, NT, NTRIALS, NGL = 24, 600, 100, 100
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: paper-run artifacts whose rate the NUTS line may publish: the port's own
#: run only.  The JAX package's runs (``results/paper_nuts*``) are TPU runs
#: and are never read here; :func:`artifact_gate_failures` refuses them
#: by their content too
PAPER_RUNS = [
    os.path.join(_ROOT, "results", "torch_paper_nuts_hetx", "paper_nuts_auditory.json"),
]

#: the live NUTS route's run (``bench.py``'s)
NUTS_CHAINS, NUTS_MAX_DEPTH = 4, 7
NUTS_WARMUP = NUTS_SAMPLES = 40
#: the health gate: largest split-R-hat, fewest mean leapfrogs per draw,
#: fewest bulk ESS per chain (ADVICE r5), smallest step size
GATE_MAX_RHAT, GATE_MIN_LEAPFROGS, GATE_ESS_PER_CHAIN, GATE_MIN_STEP = 1.05, 4.0, 100, 1e-3


def artifact_gate_failures(art) -> list:
    """Why the posterior artifact ``art`` (a dict, as a paper run or the 2D
    probe writes it) may not publish a rate; empty when it may.

    ``bench.py``'s three checks (a rate is present, ``max_rhat`` < 1.05, at
    least 4 leapfrogs a draw), then: no divergence (a missing count fails),
    a min bulk ESS of at least 100 per chain of ``config["chains"]``, every
    step size finite and above 1e-3 where the artifact records them, and an
    NVIDIA card named in ``device``.  A throughput from chains that did not
    mix, from a degenerate sampler (~1 leapfrog a draw) or from another
    device is not a headline.
    """
    rate = art.get("samples_per_s_per_chip_median")
    steps = art.get("mean_leapfrogs_per_sample")
    rhat = art.get("max_rhat")
    failures = []
    if not rate or not math.isfinite(rate):
        failures.append("no rate recorded")
    if rhat is None or not rhat < GATE_MAX_RHAT:
        failures.append("max_rhat=%s" % rhat)
    if not (steps or 0) >= GATE_MIN_LEAPFROGS:
        failures.append("mean leapfrogs %s < 4 (degenerate)" % steps)
    divergences = art.get("divergences")
    if divergences != 0:
        failures.append("divergences=%s" % divergences)
    chains = (art.get("config") or {}).get("chains")
    ess = art.get("min_ess")
    if not chains:
        failures.append("no chain count in config")
    elif ess is None or not ess >= GATE_ESS_PER_CHAIN * chains:
        failures.append("min bulk ESS %s < %d (100 a chain)" % (ess, GATE_ESS_PER_CHAIN * chains))
    step = art.get("step_size")
    if step is not None and not np.all(np.asarray(step, dtype=float) > GATE_MIN_STEP):
        failures.append("step size %s not all above %g" % (step, GATE_MIN_STEP))
    device = art.get("device")
    if not (isinstance(device, str) and device.startswith("NVIDIA")):
        failures.append("device %r is not an NVIDIA card" % (device,))
    return failures


class NutsLine(NamedTuple):
    """What the NUTS line prints: the rate (None when a gate failed), mean
    leapfrogs a draw, where it came from, the largest R-hat, the run's
    ``max_depth`` and ``chunk_size``, and the gates it failed."""

    rate: float | None
    steps: float | None
    source: str
    max_rhat: float | None
    max_depth: int | None
    chunk_size: int | None
    failures: tuple = ()
    accept: float | None = None
    divergences: int | None = None


def artifact_nuts_rate(art) -> NutsLine | None:
    """The artifact's :class:`NutsLine` when it passes
    :func:`artifact_gate_failures`, else None.  ``max_depth`` and
    ``chunk_size`` are the artifact's ``config``'s."""
    if artifact_gate_failures(art):
        return None
    cfg = art.get("config", {})
    src = "paper-run artifact (%sx(%s+%s), max_depth=%s, chunk_size=%s%s)" % (
        cfg.get("chains"), cfg.get("warmup"), cfg.get("samples"),
        cfg.get("max_depth", "?"), cfg.get("chunk_size"),
        (", metric=%s" % cfg["metric"]) if cfg.get("metric") else "",
    )
    return NutsLine(art["samples_per_s_per_chip_median"], art["mean_leapfrogs_per_sample"], src,
                    art.get("max_rhat"), cfg.get("max_depth"), cfg.get("chunk_size"),
                    accept=art.get("mean_acceptance"), divergences=art.get("divergences"))


def build_problem(seed=0, device=config.DEFAULT_DEVICE) -> GPCSD1D:
    """``bench.py``'s point: GPCSD1D at nx=24 (100 um apart), nt=600, 100
    trials of white noise from ``numpy.random.default_rng(seed)``, ngl=100,
    SE + Matern-1/2 and scalar noise, at fixed parameter values."""
    rng = np.random.default_rng(seed)
    x = (np.arange(NX) * 100.0).reshape(-1, 1)
    t = np.arange(NT).reshape(-1, 1) * 1.0
    lfp = rng.normal(size=(NX, NT, NTRIALS))
    m = GPCSD1D(lfp, x, t, ngl=NGL, device=device)
    m.R["value"] = 150.0
    m.spatial_cov.params["ell"]["value"] = 200.0
    m.temporal_cov_list[0].params["ell"]["value"] = 8.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    m.temporal_cov_list[1].params["ell"]["value"] = 3.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
    m.sig2n["value"] = 0.05
    return m


def bench_points(m, n_iters) -> np.ndarray:
    """(n_iters, dim) distinct points ``u0 + 0.01 N(0, 1)`` around the
    model's parameters, from ``numpy.random.default_rng(1)``."""
    u0 = m._fns().param_set.pack(m._theta()).cpu().numpy()
    return u0[None, :] + 0.01 * np.random.default_rng(1).normal(size=(n_iters, u0.size))


def _value_and_grad(fns, Y, u):
    """``neg_log_joint`` and its gradient at the (dim,) tensor ``u``, left on
    the device (no host read of its own)."""
    u = u.detach().requires_grad_(True)
    f = fns.neg_log_joint(u, Y)
    (g,) = torch.autograd.grad(f, u)
    return f.detach(), g


def bench_evals_per_s(m, n_iters=50, repeats=5, warmup=3) -> dict:
    """Log-joint value+grad evals/s of ``m`` on its device.

    ``warmup`` untimed evaluations at the first points (the first one timed
    on its own as ``first_call_s``), then ``repeats`` timed passes over all
    :func:`bench_points`.

    :return: dict with ``median``, ``q25``, ``q75`` (evals/s over the
        repeats), ``repeats`` (per repeat: ``evals_per_s`` and
        ``event_ms_per_eval``, the CUDA events' span over the evaluations;
        None off the card), ``event_ms_per_eval`` (their median),
        ``first_call_s``, ``value`` (``neg_log_joint`` at the last point),
        ``points``, ``evals`` and ``launches`` (quadform kernel launches
        during the call)
    """
    fns, Y, dev = m._fns(), m._Y(), m.device
    points = bench_points(m, n_iters)
    us = torch.as_tensor(points, device=dev)
    before = qf.launch_count
    t0 = time.perf_counter()
    f, _ = _value_and_grad(fns, Y, us[0])
    _sync()
    first_call_s = time.perf_counter() - t0
    if not math.isfinite(float(f)):
        raise RuntimeError(f"non-finite log-joint: {float(f)}")
    for u in us[1:warmup]:
        _value_and_grad(fns, Y, u)
    _sync()
    per_repeat = []
    for _ in range(repeats):
        events = None
        if dev.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        t0 = time.perf_counter()
        for u in us:
            f, _ = _value_and_grad(fns, Y, u)
        if events is not None:
            events[1].record()
        _sync()
        seconds = time.perf_counter() - t0
        per_repeat.append({
            "evals_per_s": n_iters / seconds,
            "event_ms_per_eval": None if events is None
            else events[0].elapsed_time(events[1]) / n_iters,
        })
    rates = [r["evals_per_s"] for r in per_repeat]
    q25, median, q75 = (float(q) for q in np.percentile(rates, [25, 50, 75]))
    event_ms = [r["event_ms_per_eval"] for r in per_repeat]
    return {
        "median": median, "q25": q25, "q75": q75, "repeats": per_repeat,
        "event_ms_per_eval": None if event_ms[0] is None else float(np.median(event_ms)),
        "first_call_s": first_call_s, "value": float(f), "points": points,
        "evals": max(warmup, 1) + repeats * n_iters, "launches": qf.launch_count - before,
    }


def reference_style_loglik_numpy(theta, x, t, gl_x, gl_w, Y):
    """Reference-semantics forward pass in plain numpy float64:
    quadrature covariances, two eighs, per-trial quad-form loop."""
    R, ell = theta["R"], theta["ell"]
    delta = x[:, None] - gl_x[None, :]
    u = delta / R
    A = gl_w[None, :] * (np.sqrt(u * u + 1) - np.abs(u))
    Kgl = np.exp(-0.5 * ((gl_x[:, None] - gl_x[None, :]) / ell) ** 2)
    Ks = A @ Kgl @ A.T + 1e-8 * np.eye(x.size)
    dt_ = t[:, None] - t[None, :]
    Kt = theta["s1"] * np.exp(-0.5 * (dt_ / theta["l1"]) ** 2) + theta["s2"] * np.exp(
        -np.abs(dt_) / theta["l2"]
    )
    lt, Qt = np.linalg.eigh(Kt)
    ls, Qs = np.linalg.eigh(Ks)
    Dvec = np.repeat(ls, t.size) * np.tile(lt, x.size) + theta["sig2n"]
    logdet = -0.5 * Y.shape[2] * np.sum(np.log(Dvec))
    quad = 0.0
    for trial in range(Y.shape[2]):  # the reference's per-trial loop
        alpha = (Qs.T @ Y[:, :, trial] @ Qt).reshape(-1)
        quad += np.sum(alpha**2 / Dvec)
    return logdet - 0.5 * quad


def baseline_inputs(m, n_iters=5):
    """The numpy baseline's parameter points (a common jitter of ``bench.py``'s
    values from ``numpy.random.default_rng(2)``) and the arguments after
    ``theta`` of :func:`reference_style_loglik_numpy` for the model ``m``."""
    from scipy.special import roots_legendre

    x = m.x.reshape(-1)
    t = m.t.reshape(-1)
    glx, glw = roots_legendre(NGL)
    a, b = x.min(), x.max()
    gl_x = 0.5 * (glx + 1) * (b - a) + a
    gl_w = 0.5 * (b - a) * glw
    thetas = []
    rng = np.random.default_rng(2)
    for _ in range(n_iters):
        j = 1.0 + 0.01 * rng.normal()
        thetas.append(
            dict(R=150.0 * j, ell=200.0 * j, s1=1.0 * j, l1=8.0 * j, s2=0.5 * j,
                 l2=3.0 * j, sig2n=0.05 * j)
        )
    return thetas, (x, t, gl_x, gl_w, m.lfp)


def bench_baseline(m, n_iters=5) -> float:
    """Evaluations per second of :func:`reference_style_loglik_numpy` (one
    thread of numpy, forward only) at :func:`baseline_inputs`."""
    thetas, args = baseline_inputs(m, n_iters)
    reference_style_loglik_numpy(thetas[0], *args)  # warm caches
    t0 = time.perf_counter()
    for th in thetas:
        reference_style_loglik_numpy(th, *args)
    dt = time.perf_counter() - t0
    return n_iters / dt


def build_nuts_problem(seed=0, device=config.DEFAULT_DEVICE) -> GPCSD1D:
    """Model-family surrogate at the bench geometry for the live NUTS route:
    prior CSD draw -> Kronecker LFP covariance -> iid noise, amplitudes
    scaled so the LFP-space signal variance is ~0.5 against sig2n 0.01 (the
    paper run's SNR regime).  A NUTS rate measured on pure-noise data is
    degenerate (~1 leapfrog a draw, VERDICT r3 weak #1), so the live route
    must pose a realistic posterior.  The covariances are the port's, built
    on ``device``; the random stream and its order are ``bench.py``'s, whose
    trial einsum is replaced by matmuls."""
    rng = np.random.default_rng(seed)
    x = (np.arange(NX) * 100.0).reshape(-1, 1)
    t = np.arange(NT).reshape(-1, 1) * 1.0
    m = GPCSD1D(np.zeros((NX, NT, NTRIALS)), x, t, ngl=NGL, device=device)
    m.R["value"] = 150.0
    m.spatial_cov.params["ell"]["value"] = 200.0
    m.temporal_cov_list[0].params["ell"]["value"] = 8.0
    m.temporal_cov_list[1].params["ell"]["value"] = 3.0
    fns = m._fns()
    # unit-sigma2 LFP-space spatial cov through the model's own quadrature
    # convention; rescale so the summed signal variance lands at 0.5
    with torch.no_grad():
        Ks = fns.build_ks(m._theta()).cpu().numpy()
    c = float(np.mean(np.diag(Ks)))
    s1, s2, sig2n = 0.35 / c, 0.15 / c, 0.01
    m.temporal_cov_list[0].params["sigma2"]["value"] = s1
    m.temporal_cov_list[1].params["sigma2"]["value"] = s2
    m.sig2n["value"] = sig2n
    with torch.no_grad():
        Kt = fns.build_kt(m._theta()).cpu().numpy()
    Ls = np.linalg.cholesky(Ks + 1e-10 * np.trace(Ks) / NX * np.eye(NX))
    Lt = np.linalg.cholesky(Kt + 1e-10 * np.trace(Kt) / NT * np.eye(NT))
    z = rng.normal(size=(NTRIALS, NX, NT))
    lfp = np.ascontiguousarray(np.moveaxis(Ls @ z @ Lt.T, 0, 2))  # (nx, nt, ntrials)
    lfp += np.sqrt(sig2n) * rng.normal(size=lfp.shape)
    m.lfp = lfp
    return m


def bench_nuts(base_evals_per_s, paths=None, device=config.DEFAULT_DEVICE) -> NutsLine:
    """NUTS samples/s/chip: from the first artifact of ``paths`` (default
    :data:`PAPER_RUNS`) that passes :func:`artifact_gate_failures`, else
    from a live run of ``sample_posterior`` (4 chains x (40 + 40), max_depth
    7, seed 5, whitened by the Laplace Hessian at the generating point) on
    :func:`build_nuts_problem`.  The live rate is 4 chains over the median
    seconds of a sampling transition; the run must pass ``bench.py``'s live
    gates (mean leapfrogs in [4, 64], mean acceptance in [0.6, 0.95], no
    divergence, max split-R-hat < 2), else its rate is None with the reasons.

    ``base_evals_per_s`` is unused here, as in ``bench.py``: the caller
    divides by it."""
    for path in PAPER_RUNS if paths is None else paths:
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            art = json.load(f)
        gated = artifact_nuts_rate(art)
        if gated is not None:
            return gated
        print(json.dumps({"note": "paper artifact failed gates; trying next",
                          "path": os.path.relpath(path, _ROOT),
                          "reasons": artifact_gate_failures(art)}), flush=True)
    dev = config.get_device(device)
    max_traj = 2 ** (NUTS_MAX_DEPTH - 1)
    times = {}
    last = {"t": time.perf_counter()}

    def cb(i, carry):
        _sync()
        now = time.perf_counter()
        times[i] = now - last["t"]
        last["t"] = now

    m = build_nuts_problem(device=dev)
    post = m.sample_posterior(n_chains=NUTS_CHAINS, num_warmup=NUTS_WARMUP,
                              num_samples=NUTS_SAMPLES, seed=5, max_depth=NUTS_MAX_DEPTH,
                              callback=cb)
    med = float(np.median([v for k, v in times.items() if k >= NUTS_WARMUP]))
    d = post.diagnostics
    steps = float(d["num_steps"].mean())
    accept = float(d["accept_prob"].mean())
    ndiv = int(d["diverging"].sum())
    max_rhat = max((float(np.max(v)) for v in d.get("rhat", {}).values()), default=float("inf"))
    src = ("live %dx(%d+%d) whitened measurement, max_depth=%d, chunk_size=1"
           % (NUTS_CHAINS, NUTS_WARMUP, NUTS_SAMPLES, NUTS_MAX_DEPTH))
    # sampler-health gates: a rate from a degenerate or non-mixing run is
    # worse than no number at all
    failures = []
    if not (GATE_MIN_LEAPFROGS <= steps <= max_traj):
        failures.append("mean leapfrogs/transition %.2f outside [4, %d]" % (steps, max_traj))
    if not (0.6 <= accept <= 0.95):
        failures.append("mean acceptance %.3f outside [0.6, 0.95]" % accept)
    if ndiv > 0:
        failures.append("%d post-warmup divergences" % ndiv)
    # the live run is short (40+40), so the R-hat gate is loose (ADVICE r4)
    if not max_rhat < 2.0:
        failures.append("max split-R-hat %s not < 2 (short-run mixing gate)" % max_rhat)
    if failures:
        src += " FAILED HEALTH GATES: " + "; ".join(failures)
    return NutsLine(None if failures else NUTS_CHAINS / med, steps, src, max_rhat,
                    NUTS_MAX_DEPTH, 1, tuple(failures), accept, ndiv)


def bench_2d(m, n_iters=30, repeats=5) -> dict:
    """``scripts/bench_2d.py``'s evals/s at its 30 points:
    :func:`bench_evals_per_s` of the 2D model ``m``."""
    return bench_evals_per_s(m, n_iters=n_iters, repeats=repeats)


def bench_baseline_2d(m, n_iters=3) -> float:
    """Reference-semantics forward pass of the 2D model ``m`` in plain numpy
    float64 (quadrature covariance, two eighs, per-trial quad-form loop,
    reference ``gpcsd2d.py:136-151``), evaluations per second; the real
    reference also pays autograd's reverse pass per objective gradient.
    The quadrature grid, weights and site-to-node distances are the
    model's own."""
    x = m.x
    Y = m.lfp
    t = m.t.reshape(-1)
    theta = m._theta()
    gl = m.spatial_cov  # reuse precomputed GL grid/weights for fairness
    delta_w = np.asarray(gl.delta_w)
    gl_w = np.asarray(gl.gl_w_prod)
    glg = np.asarray(gl.gl_x_grid)
    R, e = float(theta["R"]), m.eps
    ell1, ell2 = float(theta["ell1"]), float(theta["ell2"])

    def one(jit):
        b = np.log(R + e + np.sqrt((R + e) ** 2 + delta_w**2)) - np.log(
            e + np.sqrt(e**2 + delta_w**2)
        )
        A = gl_w[None, :] * b  # (nx, ngl)
        d1 = glg[:, None, 0] - glg[None, :, 0]
        d2 = glg[:, None, 1] - glg[None, :, 1]
        Kgl = np.exp(-0.5 * (d1 / (ell1 * jit)) ** 2 - 0.5 * (d2 / ell2) ** 2)
        Ks = A @ Kgl @ A.T + 1e-7 * np.eye(x.shape[0])
        dt_ = t[:, None] - t[None, :]
        Kt = float(theta["tm0_sigma2"]) * np.exp(
            -0.5 * (dt_ / float(theta["tm0_ell"])) ** 2
        ) + float(theta["tm1_sigma2"]) * np.exp(-np.abs(dt_) / float(theta["tm1_ell"]))
        lt, Qt = np.linalg.eigh(Kt)
        ls, Qs = np.linalg.eigh(Ks)
        Dvec = np.repeat(ls, t.size) * np.tile(lt, x.shape[0]) + float(theta["sig2n"])
        out = -0.5 * Y.shape[2] * np.sum(np.log(Dvec))
        for trial in range(Y.shape[2]):
            alpha = (Qs.T @ Y[:, :, trial] @ Qt).reshape(-1)
            out -= 0.5 * np.sum(alpha**2 / Dvec)
        return out

    one(1.0)
    t0 = time.perf_counter()
    for i in range(n_iters):
        one(1.0 + 1e-4 * i)
    return n_iters / (time.perf_counter() - t0)


def _card_or_exit():
    """``(device name, nvidia-smi line)`` of the card, after printing them
    with the torch version; None (and a message on stderr) without one."""
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card and does not fall back "
              "to the CPU", file=sys.stderr)
        return None
    name, smi = torch.cuda.get_device_name(0), nvidia_smi()
    print(json.dumps({"device": name, "nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    return name, smi


def _print_repeats(res, what):
    for i, r in enumerate(res["repeats"]):
        print(json.dumps({"repeat": i, "of": what, **r}), flush=True)
    print(json.dumps({"summary": what, **{k: res[k] for k in (
        "median", "q25", "q75", "event_ms_per_eval", "first_call_s", "value", "evals",
        "launches")}}), flush=True)


def main() -> int:
    """``bench.py``'s two JSON lines, measured on the card."""
    card = _card_or_exit()
    if card is None:
        return 2
    name, smi = card
    m = build_problem(device="cuda")
    ours = bench_evals_per_s(m)
    _print_repeats(ours, "value+grad")
    base = bench_baseline(m)
    nuts = bench_nuts(base, device="cuda")
    print(json.dumps({"numpy_baseline_evals_per_s": base}), flush=True)
    # implied reference-style sampler rate: forward evals/s / leapfrogs per
    # sample (no reverse-pass cost charged -> optimistic for the baseline)
    base_nuts = base / max(nuts.steps or 32.0, 1.0)
    power = smi.split(",")[-1].strip()
    print(json.dumps({
        "metric": "GPCSD1D log-joint value+grad evals/s (nx=24,nt=600,trials=100,ngl=100)",
        "value": ours["median"],
        "unit": "evals/s",
        "vs_baseline": ours["median"] / base,
        "device": name, "power_limit": power,
    }))
    print(json.dumps({
        "metric": "NUTS samples/s/chip, auditory config (4 chains; " + nuts.source + ")",
        "value": nuts.rate,
        "unit": "samples/s",
        "vs_baseline": None if nuts.rate is None else nuts.rate / base_nuts,
        "mean_leapfrogs_per_sample": nuts.steps,
        "max_rhat": (None if nuts.max_rhat is None or not np.isfinite(nuts.max_rhat)
                     else float(nuts.max_rhat)),
        "max_depth": nuts.max_depth,
        "chunk_size": nuts.chunk_size,
        "device": name, "power_limit": power,
    }))
    return 0


def main_2d() -> int:
    """``scripts/bench_2d.py``'s JSON line, measured on the card;
    ``first_call_s`` (the first evaluation, the lazy set-up included)
    stands where the JAX line has ``compile_s``."""
    card = _card_or_exit()
    if card is None:
        return 2
    name, smi = card
    m = paper.neuropixels_problem(0, device="cuda")
    res = bench_2d(m)
    _print_repeats(res, "value+grad 2D")
    base = bench_baseline_2d(m)
    print(json.dumps({"numpy_baseline_evals_per_s": base}), flush=True)
    print(json.dumps({
        "metric": "GPCSD2D log-joint value+grad evals/s "
                  f"(nx=69,nt={paper.NP_NT},trials={paper.NP_NTRIALS},"
                  f"ngl={paper.NP_NGL1}x{paper.NP_NGL2})",
        "value": res["median"],
        "unit": "evals/s",
        "first_call_s": res["first_call_s"],
        "neg_log_joint": res["value"],
        "vs_baseline": res["median"] / base,
        "device": name, "power_limit": smi.split(",")[-1].strip(),
    }))
    return 0
