"""Driver of the NUTS mixes: one ``sample_posterior`` call of the program.

The mix's parameters (``traffic/<mix>.json``): ``chains``, ``max_depth``,
``num_warmup`` (step-size adaptation transitions, at least 1),
``trace_transitions`` (the profiled slice of a ``--trace 1`` run) and
``check_draws`` (how many of the window's draws the reference checks).

Set-up: the benchmark takes the Hessian of the negative log-joint at the
generating point with the plain reference (:func:`prepare`) and hands it to
the program, which whitens by it; then the program's start, step-size
search and ``num_warmup`` transitions.  Both sides thus map the sampler's
coordinates by one matrix: each side's own finite-difference Hessian would
differ from the other's by ~1e-3 (the ~1e-5 eigensolver bias of the spatial
gradient over the step), and so would their maps.  The window
opens when the last of those ends and holds the sampling transitions that
follow; the benchmark's callback counts their draws and closes it at the
first transition to end after ``seconds``.  ``draws_per_s`` is every chain's
draws in the window over the window's seconds.

Correctness: at ``check_draws`` draws of the window, drawn from the seed
(the last always among them), the program's log-density and gradient (in the
sampler's whitened coordinates) against the reference's at the same point,
mapped by the whitening of the Hessian both sides were given
(:mod:`benchmark.reference.whitening`);
and the share of transitions that returned their state unchanged.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference.whitening import hessian, whitening
from benchmark.trace import Slice

#: room for the window's draws, far above what a window can hold
NUM_SAMPLES = 100_000
#: the stream of the seed that picks the checked draws
CHECK_STREAM = 1


class _WindowClosed(Exception):
    pass


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(cell, data, seed, device):
    """The Laplace Hessian both sides whiten by (float64 numpy)."""
    ref = cell.family.reference_problem(cell.config, data, torch.float64, device)
    return hessian(ref, ref.pack(data.truth))


def run(model, data, cell, seed, seconds, trace, prepared):
    from gpcsd_tpu_torch.infer import nuts

    mix, device = cell.mix, model.device
    W, C = mix["num_warmup"], mix["chains"]
    if W < 1:
        raise ValueError("num_warmup must be at least 1: the window opens after a transition")
    st = SimpleNamespace(t0=None, t1=None, ev0=0, ev1=0, rate_t0=None, rate_ev0=0, n=0,
                         z=[], logp=[], grad=[], stuck=None, prev=None)
    prof = Slice(device) if trace else None

    def callback(i, carry):
        if i < W - 1:
            return
        _sync(device)
        now = time.perf_counter()
        z, logp, grad = carry[0], carry[1], carry[2]
        if i == W - 1:
            st.t0 = st.rate_t0 = now
            st.ev0 = st.rate_ev0 = nuts.evaluations
            st.prev, st.stuck = z.clone(), torch.zeros((), dtype=torch.int64, device=device)
            if prof is not None:
                prof.start()
            return
        st.n += 1
        st.z.append(z.clone())
        st.logp.append(logp.clone())
        st.grad.append(grad.clone())
        st.stuck += torch.all(z == st.prev, dim=1).sum()
        st.prev = z.clone()
        if now - st.t0 >= seconds:
            st.t1, st.ev1 = now, nuts.evaluations
            raise _WindowClosed
        if prof is not None and prof.running and st.n >= mix["trace_transitions"]:
            prof.stop()
            _sync(device)
            st.rate_t0, st.rate_ev0 = time.perf_counter(), nuts.evaluations

    try:
        model.sample_posterior(n_chains=C, num_warmup=W, num_samples=NUM_SAMPLES, seed=seed,
                               max_depth=mix["max_depth"], callback=callback,
                               laplace_hessian=prepared)
    except _WindowClosed:
        pass
    else:
        raise RuntimeError(f"the window outlasted {NUM_SAMPLES} transitions")
    if prof is not None and prof.running:
        prof.stop()
        st.rate_t0, st.rate_ev0 = st.t1, st.ev1
    logp = torch.stack(st.logp).cpu().numpy()
    draws = C * st.n
    return SimpleNamespace(
        t_window_start=st.t0,
        e2e={"draws_per_s": draws / (st.t1 - st.t0)},
        attempted=draws,
        failed=int(np.sum(~np.isfinite(logp))),
        counters={"evals": st.ev1 - st.ev0, "draws": draws, "window_s": st.t1 - st.t0,
                  "rate_evals": st.ev1 - st.rate_ev0, "rate_s": st.t1 - st.rate_t0},
        slice=prof,
        slice_evals=st.rate_ev0 - st.ev0 if prof is not None else None,
        check=SimpleNamespace(H=prepared, z=torch.stack(st.z).cpu().numpy(), logp=logp,
                              grad=torch.stack(st.grad).cpu().numpy(),
                              stuck=int(st.stuck), draws=draws),
    )


def readings(out, cell, data, seed, device, control=None):
    """The compared numbers: ``logp_gap`` (largest relative gap of the
    log-density), ``grad_gap`` (largest relative gap of the gradient, by the
    norm of the difference), ``stuck_share`` (transitions that returned
    their state unchanged, of all in the window).

    :param control: a reference problem in a lower precision that stands in
        for the program: its values at the same points are compared instead
        (``stuck_share`` is then not read)
    """
    ref = cell.family.reference_problem(cell.config, data, torch.float64, device)
    c = ref.pack(data.truth)
    ck = out.check
    A = whitening(ck.H)
    n, C = ck.logp.shape
    rng = np.random.default_rng([seed, CHECK_STREAM])
    k = min(cell.mix["check_draws"], n * C)
    picks = [n * C - 1] + list(rng.choice(n * C - 1, size=k - 1, replace=False))
    logp_gap = grad_gap = 0.0
    for flat in picks:
        i, j = divmod(int(flat), C)
        v = ck.z[i, j]
        u = c + v @ A
        lp_ref, gu_ref = ref.log_prob(u)
        gv_ref = A @ gu_ref
        if control is None:
            lp, gv = ck.logp[i, j], ck.grad[i, j]
        else:
            lp, gu = control.log_prob(u)
            gv = A @ gu
        logp_gap = max(logp_gap, abs(lp - lp_ref) / abs(lp_ref)) if np.isfinite(lp) else np.inf
        grad_gap = max(grad_gap, np.linalg.norm(gv - gv_ref) / np.linalg.norm(gv_ref))
        if not np.all(np.isfinite(gv)):
            grad_gap = np.inf
    out_r = {"logp_gap": logp_gap, "grad_gap": grad_gap}
    if control is None:
        out_r["stuck_share"] = ck.stuck / ck.draws
    return out_r
