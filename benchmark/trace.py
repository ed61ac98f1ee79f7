"""What a ``--trace 1`` run reads from the device: a profiled slice.

:class:`Slice` wraps ``torch.profiler`` (CPU and CUDA activities) around a
stretch of the program's own work and reduces it to the device's busy time
(the union of its kernel and copy intervals), the slice's wall time, the
device time under each aten op (``key_averages``, children included, by the
op's name), the ten device operations that took most
time, and the ten host activities the device's idle gaps fell under (the
innermost CPU-side op that spans each gap's middle, ``host (python)`` where
none does).
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _union_s(intervals):
    """Total length (s) of a union of (start, end) intervals in microseconds."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-6


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Slice:
    """A profiled stretch of the program's work, between :meth:`start` and
    :meth:`stop`; :meth:`summary` reduces it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None

    @property
    def running(self):
        return self.prof is not None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        """End the slice; its events are reduced later by :meth:`summary`."""
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.done, self.prof = self.prof, None

    def summary(self) -> dict:
        """``busy_s``, ``window_s``, ``op_device_s`` (aten op name -> device
        seconds under it), ``device_ops`` and ``idle_gaps`` ([name, seconds],
        ten each)."""
        from torch.autograd import DeviceType

        events = self.done.events()
        dev, cpu = [], []
        for e in events:
            rng = (e.time_range.start, e.time_range.end)
            (dev if e.device_type == DeviceType.CUDA else cpu).append((rng, e.name))
        op_device_s = {a.key: a.device_time_total * 1e-6 for a in self.done.key_averages()}
        by_name = {}
        for (a, b), name in dev:
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "busy_s": _union_s([r for r, _ in dev]),
            "window_s": self.wall_s,
            "op_device_s": op_device_s,
            "device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": self._idle_gaps([r for r, _ in dev], cpu),
        }

    @staticmethod
    def _idle_gaps(dev, cpu):
        merged = _merged(dev)
        if len(merged) < 2 or not cpu:
            return []
        starts = np.array([r[0] for r, _ in cpu])
        ends = np.array([r[1] for r, _ in cpu])
        names = [n for _, n in cpu]
        by_host = {}
        for (_, a), (b, _) in zip(merged[:-1], merged[1:]):
            mid = 0.5 * (a + b)
            covering = np.flatnonzero((starts <= mid) & (ends > mid))
            name = names[covering[np.argmax(starts[covering])]] if covering.size else "host (python)"
            by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:10]]
