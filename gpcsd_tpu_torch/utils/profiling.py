"""Profiling / observability helpers.

Counterpart of ``gpcsd_tpu.utils.profiling``.  The reference's only hooks
are a cProfile dump in ``GPCSD2D.fit`` (``gpcsd2d.py:242-247``, the port's
``fit(profile=True)``) and tqdm progress bars.  Here the first-class
counters are the north-star metrics: marginal-likelihood evals/s and
sampler transitions/s, plus a ``torch.profiler`` trace context, the
counterpart of the JAX package's ``xla_trace``.

PyTorch returns from a call on the card before the card has done the work,
so every clock here stops after a ``torch.cuda.synchronize()`` once the
process has used CUDA.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from dataclasses import dataclass, field

import torch


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
    """``torch.profiler`` trace of the block: CPU activity and, where CUDA
    is available, the card's kernels and copies.  Yields the profiler (for
    ``key_averages()``); on exit writes a Chrome trace (``chrome://tracing``,
    Perfetto) ``<pid>.<ns>.pt.trace.json`` into ``logdir`` and sets the
    profiler's ``trace_path`` to it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
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
