"""Box-constrained L-BFGS, batched over a leading restart axis.

Counterpart of ``gpcsd_tpu.infer.lbfgs`` (``_two_loop``, ``_build``,
``lbfgs_minimize``): limited-memory BFGS two-loop recursion with circular
history buffers, Armijo backtracking on the projected step, and box
handling by projection (convergence measured on the projected gradient).
The JAX optimizer is one row's ``lax.while_loop`` batched by ``vmap``, where
a finished row is frozen by a select and the loop runs until all rows are
done.  Here that is written out: state tensors with a leading restart axis,
a Python loop, and masks.  Each row takes exactly the steps it would take
alone.

Only rows that are still live (and, inside the line search, still
searching) are evaluated: they are gathered, evaluated in one batched
value-and-gradient call and scattered back.  On the card a batched
evaluation costs the sum of its rows, so a frozen row that were still
evaluated would cost a full step.  The host reads the device once per
iteration (which rows are live) and once per line-search pass (which rows
still search); :class:`LBFGSResult` carries both counts.  Each read, and
each upload of the gathered rows' indices, is a sync on the card
(counters ``host_sync.lbfgs.live``, ``.linesearch``, ``.index``).

The JAX body evaluates the objective at the accepted point twice (the value
in the search, the gradient after it); here every trial point gets one
value-and-gradient call, which gives the same numbers.

A run can be checkpointed and stopped on a wall-clock budget, as the JAX
package's ``lbfgs_minimize_chunked`` is (``state_path``,
``max_wall_seconds``, :class:`LBFGSTimeBudget`): the whole batched state
goes to disk every ``chunk_iters`` iterations, and the same call resumes
from it.  A run stopped any number of times and rerun to completion ends
with the uninterrupted run's state bit for bit.  Not carried over is what
the chunking was for there, the bounding of each dispatch to a TPU worker:
here the iterations run in one loop whatever ``chunk_iters`` is.
"""

from __future__ import annotations

import hashlib
import time
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..io.checkpoint import load_sampler_state, sampler_state_exists, save_sampler_state
from ..models.core import value_and_grad_rows
from ..utils.profiling import count, span


class LBFGSTimeBudget(Exception):
    """Raised by :func:`lbfgs_minimize` at the first checkpoint after
    ``max_wall_seconds``: the state is saved at ``state_path`` and the SAME
    call continues from it.  Lets a driver under an outside time limit stop
    cleanly and lose no iteration."""


class LBFGSResult(NamedTuple):
    u: torch.Tensor  # (C, dim) final iterates
    f: torch.Tensor  # (C,) final objective values
    n_iter: torch.Tensor  # (C,) iterations taken
    converged: torch.Tensor  # (C,) projected-gradient tolerance met
    failed: torch.Tensor  # (C,) objective non-finite at the start
    n_evals: np.ndarray  # (C,) value-and-gradient evaluations per row
    n_syncs: int  # host reads of device state over the whole run


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _two_loop(g, s_hist, y_hist, rho, k, m):
    """Two-loop recursion over circular history buffers, one per row.

    ``g`` (L, dim), ``s_hist``/``y_hist`` (L, m, dim), ``rho`` (L, m), ``k``
    (L,) iteration counts.  Slot validity is encoded by ``rho != 0``;
    invalid slots contribute nothing.
    """
    rows = torch.arange(g.shape[0], device=g.device)
    q = g
    alphas = torch.zeros_like(rho)
    for i in range(m):  # newest -> oldest
        j = torch.remainder(k - 1 - i, m)
        valid = rho[rows, j] != 0.0
        alpha = torch.where(valid, rho[rows, j] * _dot(s_hist[rows, j], q), 0.0)
        q = q - alpha[:, None] * y_hist[rows, j]
        alphas[rows, j] = alpha

    jlast = torch.remainder(k - 1, m)
    sy = _dot(s_hist[rows, jlast], y_hist[rows, jlast])
    yy = _dot(y_hist[rows, jlast], y_hist[rows, jlast])
    gamma = torch.where((sy > 0) & (yy > 0), sy / torch.clamp(yy, min=1e-300), 1.0)
    r = gamma[:, None] * q

    for i in range(m):  # oldest -> newest
        j = torch.remainder(k - m + i, m)
        valid = rho[rows, j] != 0.0
        beta = torch.where(valid, rho[rows, j] * _dot(y_hist[rows, j], r), 0.0)
        r = r + torch.where(valid, alphas[rows, j] - beta, 0.0)[:, None] * s_hist[rows, j]
    return r


def lbfgs_minimize(
    fun: Callable,
    u0: torch.Tensor,
    lo=None,
    hi=None,
    max_iter: int = 500,
    history: int = 10,
    gtol: float = 1e-5,
    ftol: float = 2.2e-9,
    max_linesearch: int = 25,
    c1: float = 1e-4,
    row_data=None,
    chunk_iters: int = 4,
    state_path: str | None = None,
    max_wall_seconds: float | None = None,
) -> LBFGSResult:
    """Minimize ``fun`` from every row of ``u0`` subject to ``lo <= u <= hi``
    (either may be None).

    :param fun: maps ``(B, dim)`` to ``(B,)`` with independent rows, for any
        ``B``; differentiated by
        :func:`gpcsd_tpu_torch.models.core.value_and_grad_rows`.
    :param u0: ``(C, dim)`` starting points, or ``(dim,)`` for one; the
        state lives on its device.
    :param row_data: None, or a tensor or tuple of tensors, each with
        leading axis ``C``: data of each row's own problem (a trial's LFP).
        ``fun`` is then called as ``fun(u_rows, *row_data_rows)``, the data
        gathered by the same indices as the rows of ``u`` it gets.
    :param chunk_iters: iterations between two checkpoints at ``state_path``
    :param state_path: checkpoint file stem
        (:func:`gpcsd_tpu_torch.io.checkpoint.save_sampler_state`).  The
        state (iterates, values, gradients, histories, masks, counters) is
        saved every ``chunk_iters`` iterations and when the run ends, and a
        later call resumes from it when its fingerprint (a sha256 of
        ``u0``, the box, ``max_iter``, ``history``, the tolerances,
        ``max_linesearch``, ``c1`` and ``row_data``) matches this call's.  A
        checkpoint of another run, or one that cannot be read, is ignored
        with a warning.
    :param max_wall_seconds: raise :class:`LBFGSTimeBudget` at the first
        checkpoint after this many seconds of this call, unless the run has
        ended there; requires ``state_path``.  Each call makes at least
        ``chunk_iters`` iterations.
    """
    if max_wall_seconds is not None and not state_path:
        raise ValueError("max_wall_seconds requires state_path")
    if chunk_iters < 1:
        raise ValueError(f"chunk_iters must be at least 1, got {chunk_iters}")
    t_start = time.monotonic()
    u0 = torch.as_tensor(u0)
    if u0.ndim == 1:
        u0 = u0[None]
    C, dim = u0.shape
    dtype, dev, m = u0.dtype, u0.device, history
    big = torch.finfo(dtype).max
    has_box = lo is not None or hi is not None
    lo_t = torch.full((dim,), -torch.inf, dtype=dtype, device=dev) if lo is None \
        else torch.as_tensor(lo, dtype=dtype, device=dev)
    hi_t = torch.full((dim,), torch.inf, dtype=dtype, device=dev) if hi is None \
        else torch.as_tensor(hi, dtype=dtype, device=dev)

    def project(u):
        return torch.clamp(u, lo_t, hi_t) if has_box else u

    if row_data is None:
        row_data = ()
    elif isinstance(row_data, torch.Tensor):
        row_data = (row_data,)

    def evaluate(u, data):
        """Value and gradient of ``fun`` at ``u``, whose rows' data is ``data``."""
        return value_and_grad_rows(lambda v: fun(v, *data), u)

    def proj_grad_norm(u, g):
        # norm of P(u - g) - u: zero exactly at a constrained stationary point
        return torch.amax(torch.abs(project(u - g) - u), dim=-1)

    state = None
    if state_path:
        fp = _fingerprint(u0, lo, hi, row_data, max_iter, history, gtol, ftol, max_linesearch, c1)
        state = _resume(state_path, fp, dev)
    if state is None:
        u = project(u0.detach()).clone()  # the state is updated in place
        f, g = evaluate(u, row_data)
        failed = ~torch.isfinite(f)
        state = {
            "u": u, "f": torch.where(failed, big, f), "g": torch.where(torch.isfinite(g), g, 0.0),
            "s_hist": torch.zeros((C, m, dim), dtype=dtype, device=dev),
            "y_hist": torch.zeros((C, m, dim), dtype=dtype, device=dev),
            "rho": torch.zeros((C, m), dtype=dtype, device=dev),
            "k": torch.zeros(C, dtype=torch.int64, device=dev),
            "done": failed.clone(), "failed": failed,
            "n_evals": np.ones(C, dtype=np.int64), "n_syncs": 0, "iteration": 0,
        }
    u, f, g, k, done, failed = (state[n] for n in ("u", "f", "g", "k", "done", "failed"))
    s_hist, y_hist, rho = state["s_hist"], state["y_hist"], state["rho"]
    n_evals, n_syncs, n_iter = state["n_evals"], state["n_syncs"], state["iteration"]
    n_iter_start = n_iter

    while True:
        count("host_sync.lbfgs.live")
        live_h = np.flatnonzero((~done & (k < max_iter)).cpu().numpy())
        if state_path and n_iter > n_iter_start and (n_iter % chunk_iters == 0 or live_h.size == 0):
            # the tensors above are updated in place, so ``state`` holds them
            state.update(n_syncs=n_syncs, iteration=n_iter)
            save_sampler_state({"state": state, "config": fp}, state_path)
            if (live_h.size and max_wall_seconds is not None
                    and time.monotonic() - t_start > max_wall_seconds):
                raise LBFGSTimeBudget(
                    f"L-BFGS paused at iteration {n_iter} after {time.monotonic() - t_start:.1f} s; "
                    f"state saved to {state_path!r}: rerun the same call to continue"
                )
        n_syncs += 1
        if live_h.size == 0:
            break
        with span("gpcsd.lbfgs.iteration", iteration=n_iter, live=live_h.size):
            count("host_sync.lbfgs.index")
            live = torch.as_tensor(live_h, device=dev)
            ul, fl, gl, kl = u[live], f[live], g[live], k[live]
            sl, yl, rl = s_hist[live], y_hist[live], rho[live]
            data_live = tuple(r[live] for r in row_data)

            d = -_two_loop(gl, sl, yl, rl, kl, m)
            # steepest descent when the direction is not a descent direction
            d = torch.where((_dot(d, gl) < 0)[:, None], d, -gl)

            # ---- Armijo backtracking on the projected step; every row stops
            # halving at its own first success
            u_new, f_new, g_new = ul.clone(), fl.clone(), gl.clone()
            ls_ok = torch.zeros_like(fl, dtype=torch.bool)
            search_h = np.arange(live_h.size)
            for it in range(max(max_linesearch, 1)):
                with span("gpcsd.lbfgs.linesearch", it=it, rows=search_h.size):
                    count("host_sync.lbfgs.index")
                    search = torch.as_tensor(search_h, device=dev)
                    us = project(ul[search] + (0.5 ** it) * d[search])
                    fs, gs = evaluate(us, tuple(r[search] for r in data_live))
                    n_evals[live_h[search_h]] += 1
                    ok = torch.isfinite(fs) & (
                        fs <= fl[search] + c1 * _dot(gl[search], us - ul[search]))
                    u_new[search], f_new[search], g_new[search], ls_ok[search] = us, fs, gs, ok
                    count("host_sync.lbfgs.linesearch")
                    search_h = search_h[~ok.cpu().numpy()]
                n_syncs += 1
                if search_h.size == 0:
                    break

            # ---- history update, convergence, acceptance
            s = u_new - ul
            y = g_new - gl
            sy = _dot(s, y)
            do_update = ls_ok & (
                sy > 1e-10 * torch.linalg.norm(s, dim=-1) * torch.linalg.norm(y, dim=-1))
            rows = torch.arange(live_h.size, device=dev)
            slot = torch.remainder(kl, m)
            upd = do_update[:, None]
            sl[rows, slot] = torch.where(upd, s, sl[rows, slot])
            yl[rows, slot] = torch.where(upd, y, yl[rows, slot])
            rl[rows, slot] = torch.where(do_update, 1.0 / torch.clamp(sy, min=1e-300),
                                         rl[rows, slot])

            g_new = torch.where(torch.isfinite(g_new), g_new, gl)
            converged = proj_grad_norm(u_new, g_new) < gtol
            f_stall = (fl - f_new) <= ftol * torch.clamp(
                torch.maximum(torch.abs(fl), torch.abs(f_new)), min=1.0
            )
            accept = ls_ok[:, None]
            u[live] = torch.where(accept, u_new, ul)
            f[live] = torch.where(ls_ok, f_new, fl)
            g[live] = torch.where(accept, g_new, gl)
            s_hist[live], y_hist[live], rho[live] = sl, yl, rl
            k[live] = kl + 1
            done[live] = converged | ~ls_ok | f_stall
            n_iter += 1

    return LBFGSResult(
        u=u, f=f, n_iter=k, converged=proj_grad_norm(u, g) < gtol, failed=failed,
        n_evals=n_evals, n_syncs=n_syncs,
    )


def _fingerprint(u0, lo, hi, row_data, max_iter, history, gtol, ftol, max_linesearch, c1):
    """sha256 of what fixes a run: the fields JAX's ``lbfgs_minimize_chunked``
    hashes, and the bytes of ``row_data``."""
    def raw(x):
        return None if x is None else torch.as_tensor(x).detach().cpu().numpy().tobytes()

    return hashlib.sha256(repr((
        raw(u0), raw(lo), raw(hi), int(max_iter), int(history), float(gtol), float(ftol),
        int(max_linesearch), float(c1), tuple(raw(r) for r in row_data),
    )).encode()).hexdigest()


def _resume(state_path, fp, device):
    """The saved state at ``state_path`` when it is this run's, else None
    (with a warning when a checkpoint was there but not usable)."""
    if not sampler_state_exists(state_path):
        return None
    try:
        saved = load_sampler_state(state_path, device)
    except Exception as e:  # a corrupt or unreadable checkpoint: start fresh
        warnings.warn(f"lbfgs_minimize: could not resume from {state_path!r} ({e})")
        return None
    if not isinstance(saved, dict) or saved.get("config") != fp:
        warnings.warn(f"lbfgs_minimize: the checkpoint at {state_path!r} is of another run: "
                      "starting fresh")
        return None
    return saved["state"]
