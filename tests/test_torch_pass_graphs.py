"""PyTorch port: the cache of the log-joint pass's CUDA graphs
(``gpcsd_tpu_torch.models.pass_graphs``), on the CPU.

The graphs themselves need the card (``tests/test_torch_cuda.py``).  Here
the capture is replaced by the plain halves, so that what the cache decides
(eager at a key's first sighting, captured at its second, replayed after;
the least recently used key out; no capture under a profiler) and what
``value_and_grad_rows`` returns through it are checked where the tests run.
"""

import functools

import numpy as np
import pytest
import torch

from gpcsd_tpu_torch import GPCSD1D, HalfNormal
from gpcsd_tpu_torch.models import pass_graphs
from gpcsd_tpu_torch.models.core import value_and_grad_rows
from gpcsd_tpu_torch.utils import profiling

torch.set_num_threads(2)


def small_model():
    """10 sites, 40 samples, 6 trials, exact per-channel noise."""
    rng = np.random.default_rng(2)
    x = (np.arange(10) * 100.0).reshape(-1, 1)
    t = np.arange(40.0).reshape(-1, 1)
    m = GPCSD1D(rng.normal(size=(10, 40, 6)), x, t, ngl=40, het_noise="exact",
                sig2n_prior=[HalfNormal(0.1) for _ in range(10)], device="cpu")
    m.R["value"] = 120.0
    m.spatial_cov.params["ell"]["value"] = 180.0
    return m


def plain_capture(self, objective, u, Y):
    """Stands in for the capture on the CPU: the halves behind the autograd
    boundary their graphs replay behind."""
    return tuple(functools.partial(pass_graphs._EagerHalf.apply, half)
                 for half in self.plain_halves(objective, Y))


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Graphs engaged for CPU rows, captured as the plain halves."""
    monkeypatch.setattr(pass_graphs, "eligible",
                        lambda u: pass_graphs._pass["engaged"] and u.requires_grad)
    monkeypatch.setattr(pass_graphs.PassGraphs, "_capture", plain_capture)


def counts():
    c = profiling.counters()
    return [c.get(f"graph.{k}", 0) for k in ("eager", "capture", "replay")]


def rows(m, fns, n, seed):
    u0 = fns.param_set.pack(m._theta())
    return u0 + 0.05 * torch.tensor(np.random.default_rng(seed).normal(size=(n, u0.numel())))


@pytest.mark.parametrize("objective", ["log_prob", "neg_log_joint"])
def test_a_key_replays_from_its_second_sighting(cpu_graphs, objective):
    """Three passes at one row count: eager, captured, replayed, each the
    plain log-joint's values bit for bit and its gradient to 1e-13 (autograd
    adds u's partial gradients in another order); a fourth, replayed at the
    first pass's rows, gives that eager pass's bits."""
    m = small_model()
    fns, Y = m._fns(), m._Y()
    fn = getattr(fns, objective)
    before = np.array(counts())
    results = []
    for seed in range(3):
        u = rows(m, fns, 3, seed)
        v, g = value_and_grad_rows(lambda x: fn(x, Y), u)
        results.append((v, g))
        ut = u.clone().requires_grad_()
        want = fn(ut, Y)
        (gw,) = torch.autograd.grad(want.sum(), ut)
        assert torch.equal(v, want.detach())
        assert float((g - gw).norm()) <= 1e-13 * float(gw.norm())
    v, g = value_and_grad_rows(lambda x: fn(x, Y), rows(m, fns, 3, 0))
    assert torch.equal(v, results[0][0]) and torch.equal(g, results[0][1])
    assert list(np.array(counts()) - before) == [1, 1, 3]


def test_the_cache_keeps_the_most_recent_keys(cpu_graphs):
    """One pass at each of MAX_KEYS + 1 row counts keeps MAX_KEYS keys; the
    first, gone, runs eagerly again instead of capturing."""
    m = small_model()
    fns, Y = m._fns(), m._Y()
    fn = lambda x: fns.log_prob(x, Y)  # noqa: E731
    before = np.array(counts())
    for n in range(1, pass_graphs.MAX_KEYS + 2):
        value_and_grad_rows(fn, rows(m, fns, n, n))
    assert len(fns.graphs) == pass_graphs.MAX_KEYS
    value_and_grad_rows(fn, rows(m, fns, 1, 0))
    value_and_grad_rows(fn, rows(m, fns, pass_graphs.MAX_KEYS + 1, 0))
    assert list(np.array(counts()) - before) == [pass_graphs.MAX_KEYS + 2, 1, 1]


def test_no_capture_under_a_profiler(cpu_graphs):
    """A key's second sighting under a running profiler runs eagerly; the
    next one, with the profiler stopped, captures."""
    m = small_model()
    fns, Y = m._fns(), m._Y()
    fn = lambda x: fns.log_prob(x, Y)  # noqa: E731
    before = np.array(counts())
    value_and_grad_rows(fn, rows(m, fns, 2, 0))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        value_and_grad_rows(fn, rows(m, fns, 2, 1))
    assert list(np.array(counts()) - before) == [2, 0, 0]
    value_and_grad_rows(fn, rows(m, fns, 2, 2))
    assert list(np.array(counts()) - before) == [2, 1, 1]


def test_only_passes_engage_graphs():
    """Outside ``value_and_grad_rows``, or on the CPU, a log-joint call is
    not eligible for graphs."""
    u = torch.zeros(3, 4, requires_grad=True)
    assert not pass_graphs.eligible(u)
    with pass_graphs.engaged():
        assert not pass_graphs.eligible(u)  # CPU rows
    assert not pass_graphs._pass["engaged"]


def test_vjp_matches_autograd_grad():
    """The capture's vector-Jacobian product gives ``autograd.grad`` with
    ``grad_outputs`` bit for bit."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(3, 5)), requires_grad=True)
    y = torch.tensor(rng.normal(size=5), requires_grad=True)
    outs = (torch.exp(x) * y, torch.log1p(y * y).sum())
    cot = (torch.tensor(rng.normal(size=(3, 5))), torch.tensor(1.7))
    want = torch.autograd.grad(outs, (x, y), grad_outputs=cot, retain_graph=True)
    got = pass_graphs._vjp(outs, (x, y), cot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
