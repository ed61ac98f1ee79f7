"""Profiling / observability helpers: the program's spans and counters.

Counterpart of ``gpcsd_tpu.utils.profiling``.  The reference's only hooks
are a cProfile dump in ``GPCSD2D.fit`` (``gpcsd2d.py:242-247``, the port's
``fit(profile=True)``) and tqdm progress bars.  Here the first-class
counters are the north-star metrics: marginal-likelihood evals/s and
sampler transitions/s, plus a ``torch.profiler`` trace context, the
counterpart of the JAX package's ``xla_trace``.

The program's own instruments:

- :func:`span` (and :func:`traced_call`, :func:`pass_span`): a named range
  around one layer's work (``gpcsd.nuts.transition``, ``gpcsd.pass``,
  ``gpcsd.kronlik.comp_eig_d``, ...).  While a ``torch.profiler`` runs it
  is a range in the profiler's own record, on its clock and in the
  timeline of the kernels: the profiler puts each kernel under the range
  open when it was launched, so the device time under a span and the span
  each idle gap of the device falls in come out of the trace itself.
  Otherwise a span costs one flag check.  Its ids (call, pass, index,
  rows) are the range's arguments, never part of its name, so that
  ``key_averages()`` groups by name; a ``record_shapes=True`` profile
  (as :func:`trace`'s) keeps them.
- :func:`count`: a registry of event counters (``pass.count``,
  ``pass.rows``, ``host_sync.<site>``), always on, one dict addition an
  event; :func:`counters` reads it and :func:`reset_counters` clears it.
  Counters a kernel keeps on the device (``kronlik.jacobi.sweeps``) join
  the registry through :func:`add_counter_source`: read, and so waited
  for, only when the registry is read.

Neither changes a number the program computes.

PyTorch returns from a call on the card before the card has done the work,
so every clock here stops after a ``torch.cuda.synchronize()`` once the
process has used CUDA.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import subprocess
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

#: Counts of the program's events since import or :func:`reset_counters`:
#: ``pass.count`` and ``pass.rows`` (batched value+grad passes and the rows
#: they evaluated, in :func:`gpcsd_tpu_torch.models.core.value_and_grad_rows`)
#: and ``host_sync.<site>`` (each place where the program's control flow
#: waits for the device, counted at the line that waits, on any device).
_counters: dict = {}

#: The call (one ``sample_posterior`` or ``fit``) and the batched pass that
#: the spans opened now belong to.  Set only while a profiler runs.  A
#: module slot, not a thread-local one: a backward span runs on autograd's
#: device thread and carries the pass of the forward that made it.
_current = {"call": None, "pass": None}
_call_ids = itertools.count(1)
_pass_ids = itertools.count(1)
_NO_SPAN = contextlib.nullcontext()


#: ``(read, reset)`` of each source of counters kept outside the registry
_sources: list = []


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def add_counter_source(read, reset):
    """Join counters kept elsewhere to the registry: ``read(host)`` gets
    the registry's own counters and returns more (name -> value), at each
    :func:`counters`; ``reset()`` runs at each :func:`reset_counters`."""
    _sources.append((read, reset))


def counters() -> dict:
    """A snapshot of every counter."""
    out = dict(_counters)
    for read, _ in _sources:
        out.update(read(out))
    return out


def reset_counters():
    """Set every counter back to nothing."""
    _counters.clear()
    for _, reset in _sources:
        reset()


class _Span:
    """A profiler range named ``name`` whose arguments are the open call
    and pass and ``ids``; with ``opens`` ("call" or "pass") it sets that
    slot for what runs inside (a call only when none is open) and puts it
    back on exit."""

    __slots__ = ("name", "ids", "opens", "outer", "record")

    def __init__(self, name, ids, opens=None):
        self.name, self.ids, self.opens = name, ids, opens

    def __enter__(self):
        if self.opens is not None:
            self.outer = _current[self.opens]
            if self.opens == "pass":
                _current["pass"] = next(_pass_ids)
            elif self.outer is None:
                _current["call"] = next(_call_ids)
        args = {k: v for k, v in _current.items() if v is not None}
        args.update(self.ids)
        # not ``torch.profiler.record_function``: its user-scope range adds a
        # second event on the device's timeline, spanning the range's kernels,
        # which a reader of device activity would take for work
        self.record = torch._C._profiler._RecordFunctionFast(self.name, (), args)
        self.record.__enter__()
        return self

    def __exit__(self, *exc):
        self.record.__exit__(*exc)
        if self.opens is not None:
            _current[self.opens] = self.outer
        return False


def span(name: str, **ids):
    """Context manager: a range ``name`` in the running ``torch.profiler``'s
    record, with ``ids`` (ints, floats, bools or strings) and the open call
    and pass as its arguments; nothing but one flag check when no profiler
    runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, ids)


def traced_call(name: str):
    """Decorator of an entry point (``gpcsd.sample_posterior``, ``gpcsd.fit``):
    each call runs inside span ``name``, which opens a call id that every
    span inside it carries, unless an outer entry point has opened one."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, {}, opens="call"):
                return fn(*args, **kwargs)
        return traced
    return wrap


def pass_span(rows: int):
    """:func:`span` ``gpcsd.pass`` of one batched value+grad pass over
    ``rows`` rows: opens a pass id, which every span inside it carries,
    those of its backward on autograd's thread included."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span("gpcsd.pass", {"rows": rows}, opens="pass")


def _sync():
    """Wait for the card's queued work, if this process has used CUDA."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def nvidia_smi() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``): every number measured on a card
    is kept beside this line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace of the block: CPU activity, the program's
    spans with their ids and, where CUDA is available, the card's kernels
    and copies.  Yields the profiler (for ``key_averages()``); on exit
    writes a Chrome trace (``chrome://tracing``, Perfetto)
    ``<pid>.<ns>.pt.trace.json`` into ``logdir`` and sets the profiler's
    ``trace_path`` to it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
        _sync()
    prof.trace_path = os.path.join(logdir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(prof.trace_path)


@dataclass
class Throughput:
    """Wall-clock throughput counter for repeated device calls.

    Measures honestly on asynchronous devices: the clock stops after the
    card has finished, over many iterations with distinct inputs.
    """

    name: str = "evals"
    count: int = 0
    seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.seconds += time.perf_counter() - self._t0
        return False

    def add(self, n=1):
        self.count += n

    @property
    def rate(self):
        return self.count / self.seconds if self.seconds > 0 else float("nan")

    def __str__(self):
        return f"{self.name}: {self.count} in {self.seconds:.2f}s = {self.rate:.2f}/s"


def measure_evals_per_second(fn, args_list, warmup=1):
    """Calls per second of ``fn`` over a list of argument tuples, after
    ``warmup`` untimed calls on the first of them."""
    for a in args_list[:warmup]:
        fn(*a)
    _sync()
    t0 = time.perf_counter()
    for a in args_list:
        fn(*a)
    _sync()
    return len(args_list) / (time.perf_counter() - t0)
