"""Faults planted in the program under test, to show that ``correct`` catches
them (the tests, and :mod:`benchmark.control` for the readings on the card).

A mix's driver may define ``plant(name)``, a context manager that plants
fault ``name`` for its own engine; :func:`planted` uses it where it is
defined.  Otherwise, for the ``nuts`` and ``map`` engines, each fault is a
context manager that swaps one of the program's functions:

- ``unchanged``: a step returns its state unchanged (a NUTS transition
  returns its start; L-BFGS makes no iteration, so a fit returns its starts);
- ``half_batch``: the log-likelihood leaves out half of the trials and takes
  the quadratic term's mean over the rest (twice their sum);
- ``altered``: the quadratic term is altered where it is produced (by a
  relative 1e-3).

``half_batch`` and ``altered`` swap ``kronlik.quad_term``, which every path
of the log-likelihood calls: ``kronlik.loglik`` on the CPU, and the card's
CUDA-graph pass (``models.pass_graphs``), which computes the log-likelihood
around it without ``kronlik.loglik``.
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
    def quad_term(factors, Y):
        return 2.0 * old(factors, Y[: Y.shape[0] // 2])
    return quad_term


def _altered(old):
    def quad_term(factors, Y):
        return old(factors, Y) * (1.0 + 1e-3)
    return quad_term


@contextlib.contextmanager
def planted(name, engine, driver=None):
    """Plant fault ``name`` for a mix of ``engine``: by ``driver.plant(name)``
    where the mix's driver defines it, else by the swaps above for ``"nuts"``
    and ``"map"``; raises ValueError for another engine."""
    plant = getattr(driver, "plant", None)
    if plant is not None:
        with plant(name):
            yield
        return
    if engine not in ("nuts", "map"):
        raise ValueError(f"no fault {name!r} for engine {engine!r}: its driver defines no plant")
    from gpcsd_tpu_torch.infer import map as map_mod
    from gpcsd_tpu_torch.infer import nuts
    from gpcsd_tpu_torch.ops import kronlik

    if name == "unchanged":
        swap = (_swap(nuts, "nuts_transition", _unchanged_transition) if engine == "nuts"
                else _swap(map_mod, "lbfgs_minimize", _no_iterations))
    elif name == "half_batch":
        swap = _swap(kronlik, "quad_term", _half_batch)
    elif name == "altered":
        swap = _swap(kronlik, "quad_term", _altered)
    else:
        raise ValueError(f"unknown fault {name!r}")
    with swap:
        yield


FAULTS = ("unchanged", "half_batch", "altered")
