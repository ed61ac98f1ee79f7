"""Driver of the MAP mixes: multi-restart fits of the program, back to back.

The mix's parameters (``traffic/<mix>.json``): ``restarts`` per fit,
``warmup_iters`` (the iterations of the set-up's short fit, which runs the
batched shapes once) and ``trace_iters`` (the iterations of the profiled fit
of a ``--trace 1`` run, made after the window).

Fit ``k`` of a run draws its restarts from the seed as ``[seed, k]`` (the
set-up's fit is ``k = 0``).  The window opens after set-up; fits run back to
back and none starts once ``seconds`` have passed.  ``map_fit_s`` is the time
from the window's opening to the end of its last whole fit, over the number
of whole fits.

Correctness: every finite restart's reported NLL against the reference's at
the restart's returned point, and, from each fit's best point, how far the
reference's NLL still falls along its projected steepest-descent path (the
best of the steps ``2^-j`` times the gradient, j = 0..40, clipped into the box),
relative to the NLL: small at a point the optimizer has converged to, about 1
at a prior draw, which is where a fit that never moved would stop.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.trace import Slice


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(cell, data, seed, device):
    """Nothing: a fit needs no input besides the data and its seed."""
    return None


def run(model, data, cell, seed, seconds, trace, prepared):
    mix, device = cell.mix, model.device
    R = mix["restarts"]
    model.fit(n_restarts=R, backend="torch", seed=[seed, 0], options={"maxiter": mix["warmup_iters"]})
    _sync(device)
    t0 = time.perf_counter()
    fits, t_end, k = [], t0, 1
    while not fits or time.perf_counter() - t0 < seconds:
        res = model.fit(n_restarts=R, backend="torch", seed=[seed, k])
        _sync(device)
        t_end = time.perf_counter()
        fits.append(res)
        k += 1
    evals = int(sum(int(np.sum(r.n_evals)) for r in fits))
    prof, slice_evals = None, None
    if trace:
        prof = Slice(device)
        prof.start()
        res = model.fit(n_restarts=R, backend="torch", seed=[seed, k],
                        options={"maxiter": mix["trace_iters"]})
        prof.stop()
        slice_evals = int(np.sum(res.n_evals))
    nll = np.concatenate([r.nll_values for r in fits])
    return SimpleNamespace(
        t_window_start=t0,
        e2e={"map_fit_s": (t_end - t0) / len(fits)},
        attempted=int(nll.size),
        failed=int(np.sum(~np.isfinite(nll))),
        counters={"evals": evals, "fits": len(fits), "window_s": t_end - t0,
                  "rate_evals": evals, "rate_s": t_end - t0},
        slice=prof,
        slice_evals=slice_evals,
        check=SimpleNamespace(u_all=[r.u_all for r in fits], nll=[r.nll_values for r in fits],
                              u_best=[r.u_best for r in fits]),
    )


#: the descent probe's steps, 2^-j times the gradient
DESCENT_STEPS = 2.0 ** -np.arange(41)


def descent(ref, u, lo, hi):
    """Relative fall of ``ref``'s NLL from ``u`` along the projected
    steepest-descent path (the best step of :data:`DESCENT_STEPS`)."""
    f0, g = ref.nll(u)
    best = f0
    for step in DESCENT_STEPS:
        try:
            f = -ref.value(np.clip(u - step * g, lo, hi), jacobian=False)
        except torch.linalg.LinAlgError:  # no factorization at the box's far corners
            continue
        if np.isfinite(f):
            best = min(best, f)
    return (f0 - best) / abs(f0)


def readings(out, cell, data, seed, device, control=None):
    """The compared numbers: ``nll_gap`` (largest relative gap of a finite
    restart's NLL) and ``descent`` (largest :func:`descent` from a fit's best
    point, by the reference; not read for a control).

    :param control: a reference problem in a lower precision that stands in
        for the program's NLLs
    """
    ref = cell.family.reference_problem(cell.config, data, torch.float64, device)
    lo, hi = ref.bounds()
    ck = out.check
    nll_gap, fall = 0.0, 0.0
    for u_all, nll, u_best in zip(ck.u_all, ck.nll, ck.u_best):
        for u, f in zip(u_all, nll):
            if not np.isfinite(f):
                continue
            f_ref = ref.nll(u)[0]
            if control is not None:
                f = control.nll(u)[0]
            nll_gap = max(nll_gap, abs(f - f_ref) / abs(f_ref)) if np.isfinite(f) else np.inf
        if control is None:
            fall = max(fall, descent(ref, u_best, lo, hi))
    out_r = {"nll_gap": nll_gap}
    if control is None:
        out_r["descent"] = fall
    return out_r
