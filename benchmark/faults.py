"""Faults planted in the program under test, to show that ``correct`` catches
them (the tests, and :mod:`benchmark.control` for the readings on the card).

Each is a context manager that swaps one of the program's functions:

- ``unchanged``: a step returns its state unchanged (a NUTS transition
  returns its start; L-BFGS makes no iteration, so a fit returns its starts);
- ``half_batch``: the log-likelihood leaves out half of the trials and takes
  the quadratic term's mean over the rest (twice their sum);
- ``altered``: the quadratic term is altered where it is produced (by a
  relative 1e-3).
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def _swap(module, name, new):
    old = getattr(module, name)
    setattr(module, name, new(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _unchanged_transition(old):
    from gpcsd_tpu_torch.infer.nuts import NUTSStats

    def transition(vg, z, logp, grad, noise, step_size, inv_mass, max_depth=10):
        zeros = torch.zeros_like(logp)
        return z, logp, grad, NUTSStats(accept_prob=zeros, num_steps=zeros.long(), depth=zeros.long(),
                                        diverging=zeros.bool(), energy=-logp)
    return transition


def _no_iterations(old):
    @functools.wraps(old)
    def minimize(*args, **kw):
        return old(*args, **{**kw, "max_iter": 0})
    return minimize


def _half_batch(old):
    def loglik(factors, Y, ntrials=None):
        from gpcsd_tpu_torch.ops import kronlik

        T = Y[..., 0, 0].numel() if ntrials is None else ntrials
        half = Y[: Y.shape[0] // 2]
        logdet = T * (torch.sum(torch.log(factors.d), dim=(-2, -1)) + factors.logdet_offset)
        return -0.5 * (logdet + 2.0 * kronlik.quad_term(factors, half))
    return loglik


def _altered(old):
    def quad_term(factors, Y):
        return old(factors, Y) * (1.0 + 1e-3)
    return quad_term


@contextlib.contextmanager
def planted(name, engine):
    """Plant fault ``name`` for a mix of ``engine`` (``"nuts"`` or ``"map"``)."""
    from gpcsd_tpu_torch.infer import map as map_mod
    from gpcsd_tpu_torch.infer import nuts
    from gpcsd_tpu_torch.ops import kronlik

    if name == "unchanged":
        swap = (_swap(nuts, "nuts_transition", _unchanged_transition) if engine == "nuts"
                else _swap(map_mod, "lbfgs_minimize", _no_iterations))
    elif name == "half_batch":
        swap = _swap(kronlik, "loglik", _half_batch)
    elif name == "altered":
        swap = _swap(kronlik, "quad_term", _altered)
    else:
        raise ValueError(f"unknown fault {name!r}")
    with swap:
        yield


FAULTS = ("unchanged", "half_batch", "altered")
