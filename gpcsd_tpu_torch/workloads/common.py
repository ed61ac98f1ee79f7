"""Shared helpers for the workload twins, counterpart of ``workloads/common.py``
(``report``, ``mse``, ``r2``, ``paired_t``, ``maybe_savefig``), and the
stage clock the twins fill when asked."""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch


def mse(a, b, axis=None):
    return np.mean(np.square(np.asarray(a) - np.asarray(b)), axis=axis)


def r2(pred, truth, axis=None):
    truth = np.asarray(truth)
    pred = np.asarray(pred)
    ss_res = np.sum(np.square(truth - pred), axis=axis)
    ss_tot = np.sum(np.square(truth - np.mean(truth, axis=axis, keepdims=True)), axis=axis)
    return 1.0 - ss_res / ss_tot


def paired_t(a, b):
    """Paired t-test (two-sided); returns (t, p) without scipy.stats clutter."""
    from scipy import stats

    return stats.ttest_rel(np.asarray(a), np.asarray(b))


def report(name, metrics, results_dir=None):
    """Print a metric dict and optionally save it as JSON."""
    print(f"== {name} ==")
    for k, v in metrics.items():
        print(f"  {k}: {v}")
    if results_dir:
        os.makedirs(results_dir, exist_ok=True)
        path = os.path.join(results_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump({k: _jsonable(v) for k, v in metrics.items()}, f, indent=2)
    return metrics


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def maybe_savefig(fig, results_dir, name):
    """Save ``fig`` as ``results_dir/name`` (120 dpi) when ``results_dir`` is set."""
    if results_dir:
        os.makedirs(results_dir, exist_ok=True)
        fig.savefig(os.path.join(results_dir, name), dpi=120, bbox_inches="tight")


@contextlib.contextmanager
def stage(timings, name, device):
    """Add the seconds of the enclosed stage to ``timings[name]`` (nothing
    when ``timings`` is None), synchronising a CUDA ``device`` at both ends
    so the device's work is inside the interval."""
    if timings is None:
        yield
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(device)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0
