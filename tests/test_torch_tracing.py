"""PyTorch port, the program's spans and counters (``utils/profiling.py``)
on the CPU: the spans one ``sample_posterior`` call and one fit open, the
host-sync counters against a hand count, nothing entered without a
profiler, the same draws and fits with a profiler on and off, and a traced
run of the benchmark's cells at a small size reading the new metrics.
"""

import collections
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run as harness
from benchmark.tests.helpers import small_bench
from gpcsd_tpu_torch import GPCSD1D, HalfNormal
from gpcsd_tpu_torch.utils import profiling

torch.set_num_threads(2)


def small_model():
    """A per-channel-noise GPCSD1D small enough for a few transitions a second."""
    rng = np.random.default_rng(2)
    x = (np.arange(6) * 100.0).reshape(-1, 1)
    t = np.arange(20.0).reshape(-1, 1)
    m = GPCSD1D(rng.normal(size=(6, 20, 4)), x, t, device="cpu", ngl=20,
                sig2n_prior=[HalfNormal(0.1) for _ in range(6)], het_noise="exact")
    m.R["value"] = 120.0
    m.spatial_cov.params["ell"]["value"] = 180.0
    return m


def delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def profiled(fn):
    """``fn()`` under a CPU ``torch.profiler`` that keeps the spans' ids:
    (its result, the ``(name, ids)`` of the profiler's ``gpcsd.*`` ranges in
    order, the counters' change).  The ranges are read from the profiler's
    raw record: its ``events()`` would take seconds to build every op's."""
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    raw = sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
    spans = [(e.name(), e.kwinputs()) for e in raw if e.name().startswith("gpcsd.")]
    return out, spans, delta(before, profiling.counters())


def test_spans_of_one_sample_posterior_call():
    """Each span as often as what it wraps: one call, a transition and a
    callback each, a ``gpcsd.pass`` per counted pass, in each pass one
    factorization and one quadratic term, two ``eigh`` backwards and a
    quadform backward a row; every span carries the call's id, and the
    spans of a pass (its backward's too) that pass's id."""
    m = small_model()
    seen = []
    post, spans, c = profiled(lambda: m.sample_posterior(
        n_chains=2, num_warmup=2, num_samples=1, seed=1, max_depth=3,
        callback=lambda i, carry: seen.append(i)))
    n = collections.Counter(name for name, _ in spans)
    assert n["gpcsd.sample_posterior"] == 1
    assert n["gpcsd.nuts.transition"] == n["gpcsd.nuts.callback"] == len(seen) == 3
    assert n["gpcsd.pass"] == n["gpcsd.pass.backward"] == c["pass.count"] > 0
    assert n["gpcsd.kronlik.comp_eig_d"] == n["gpcsd.kronlik.quad_term"] == c["pass.count"]
    assert n["gpcsd.kronlik.eigh_backward"] == 2 * c["pass.count"] == c["host_sync.kronlik.eigh"]
    assert n["gpcsd.quadform.backward"] == c["pass.rows"]
    # one doubling per depth check that found a chain still running
    assert 0 < n["gpcsd.nuts.subtree"] <= c["host_sync.nuts.depth"]
    assert len({ids["call"] for _, ids in spans}) == 1
    pass_ids = [ids["pass"] for name, ids in spans if name == "gpcsd.pass"]
    assert len(set(pass_ids)) == len(pass_ids)
    for name, ids in spans:
        if name in ("gpcsd.kronlik.eigh_backward", "gpcsd.quadform.backward",
                    "gpcsd.kronlik.comp_eig_d", "gpcsd.pass.backward"):
            assert ids["pass"] in pass_ids
        if name in ("gpcsd.nuts.transition", "gpcsd.sample_posterior"):
            assert "pass" not in ids
    transitions = [ids for name, ids in spans if name == "gpcsd.nuts.transition"]
    assert [(t["i"], t["warm"]) for t in transitions] == [(i, i < 2) for i in range(3)]
    assert np.all(np.isfinite(post.raw.samples.numpy()))


def test_spans_and_syncs_of_one_fit():
    """A fit: one ``gpcsd.fit`` and one ``gpcsd.map_fit`` sharing one call
    id; an iteration span per pass of the optimizer's loop (the loop ends at
    a live read that finds no row); a line-search span per Armijo pass, each
    one value+grad pass after the start's; syncs: a live read per iteration
    and the last, an index upload per iteration and per line-search pass, a
    read per line-search pass, two ``eigh`` a pass."""
    m = small_model()
    res, spans, c = profiled(lambda: m.fit(n_restarts=3, seed=0, options={"maxiter": 4}))
    n = collections.Counter(name for name, _ in spans)
    assert n["gpcsd.fit"] == n["gpcsd.map_fit"] == 1
    assert len({ids["call"] for _, ids in spans}) == 1
    iters, searches = n["gpcsd.lbfgs.iteration"], n["gpcsd.lbfgs.linesearch"]
    assert 0 < iters <= 4 and searches >= iters
    assert c["pass.count"] == n["gpcsd.pass"] == 1 + searches
    assert c["pass.rows"] == int(res.n_evals.sum())
    assert c["host_sync.lbfgs.live"] == iters + 1
    assert c["host_sync.lbfgs.index"] == iters + searches
    assert c["host_sync.lbfgs.linesearch"] == searches
    assert c["host_sync.kronlik.eigh"] == 2 * c["pass.count"]
    assert set(k for k in c if k.startswith("host_sync.")) == {
        "host_sync.lbfgs.live", "host_sync.lbfgs.index", "host_sync.lbfgs.linesearch",
        "host_sync.kronlik.eigh"}
    assert res.n_syncs == c["host_sync.lbfgs.live"] + c["host_sync.lbfgs.linesearch"]
    rows = [ids["rows"] for name, ids in spans if name == "gpcsd.lbfgs.linesearch"]
    assert sum(rows) == c["pass.rows"] - 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_syncs_of_a_transition_match_a_hand_count(seed):
    """One chain, one transition of ``n`` leapfrogs: its depth is
    ``d = n.bit_length()``; the host waits 4 times for the noise, at every
    depth check (``d``, and once more when the tree stopped below
    ``max_depth``), at every leaf check (``n``, and once more when a
    doubling stopped inside), and twice a pass for the ``eigh``s."""
    m, max_depth = small_model(), 4
    snaps = []
    post = m.sample_posterior(n_chains=1, num_warmup=0, num_samples=6, seed=seed,
                              max_depth=max_depth,
                              callback=lambda i, carry: snaps.append(profiling.counters()))
    steps = post.diagnostics["num_steps"][0]
    for i in range(1, len(snaps)):
        n = int(steps[i])
        d = n.bit_length()
        assert delta(snaps[i - 1], snaps[i]) == {
            "host_sync.nuts.noise": 4,
            "host_sync.nuts.depth": d + (d < max_depth),
            "host_sync.nuts.leaf": n + (n < 2 ** d - 1),
            "host_sync.kronlik.eigh": 2 * n,
            "pass.count": n, "pass.rows": n,
        }


def test_no_range_entered_without_a_profiler(monkeypatch):
    """With no profiler running, a span enters no profiler range; the
    counters count all the same."""
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was entered with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    m = small_model()
    before = profiling.counters()
    m.sample_posterior(n_chains=2, num_warmup=2, num_samples=2, seed=3, max_depth=3)
    m.fit(n_restarts=2, seed=0, options={"maxiter": 2})
    c = delta(before, profiling.counters())
    assert c["pass.count"] > 0 and c["host_sync.nuts.leaf"] > 0 and c["host_sync.lbfgs.live"] > 0
    with profiling.span("gpcsd.test", i=1), profiling.pass_span(3):
        assert profiling.traced_call("gpcsd.test_call")(lambda: 7)() == 7


def test_draws_and_fits_bit_for_bit_with_a_profiler():
    """The same draws and the same fit with a profiler on and off."""
    def run():
        m = small_model()
        post = m.sample_posterior(n_chains=2, num_warmup=2, num_samples=2, seed=4, max_depth=3)
        fit = m.fit(n_restarts=3, seed=1, options={"maxiter": 3})
        return post.raw, fit

    (off_post, off_fit) = run()
    (on_post, on_fit), spans, _ = profiled(run)
    assert spans
    for a, b in zip(off_post, on_post):
        assert torch.equal(a, b)
    assert np.array_equal(off_fit.u_all, on_fit.u_all)
    assert np.array_equal(off_fit.nll_values, on_fit.nll_values)
    assert np.array_equal(off_fit.n_evals, on_fit.n_evals)


def test_reset_counters():
    profiling.count("test.events", 3)
    profiling.count("test.events")
    assert profiling.counters()["test.events"] == 4
    snap = profiling.counters()
    snap["test.events"] = 0
    assert profiling.counters()["test.events"] == 4
    profiling.reset_counters()
    assert profiling.counters() == {}


@pytest.mark.parametrize("workload", ["auditory-nuts", "auditory-map"])
def test_traced_cell_reads_the_program(tmp_path, monkeypatch, workload):
    """A traced run of the cell at a small size on the CPU reports
    ``rows_per_pass`` and ``host_syncs_per_pass``; the span readers find no
    device time there and give None, not 0, so the line leaves them out."""
    # this test process has JAX loaded (the suite's conftest); the run may not
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    bench = small_bench(tmp_path, mixes={"nuts-c4-d3": {"num_warmup": 2, "check_draws": 3},
                                         "map-r10": {"restarts": 3, "trace_iters": 2}})
    cell = bench.cell(workload)
    kind = workload.split("-")[-1]
    profiling.reset_counters()
    result = harness.run_cell(cell, 2**31 + 41, 0.5, True, device="cpu")
    metrics = result["metrics"]
    assert metrics[f"rows_per_pass.{kind}"]["value"] >= 1.0
    assert metrics[f"host_syncs_per_pass.{kind}"]["value"] >= 2.0
    for name in (f"factor_ms_per_eval.{kind}", f"quad_term_roofline.{kind}"):
        assert name not in metrics
        reader = dict((m["name"], r) for m, r in cell.per_layer)[name]
        no_device_time = {"gpcsd.kronlik.comp_eig_d": 0.0, "gpcsd.kronlik.eigh_backward": 0.0,
                          "gpcsd.kronlik.quad_term": 0.0}
        ctx = SimpleNamespace(slice={"op_device_s": no_device_time}, slice_evals=10,
                              shape=(8, 60, 10))
        assert reader.read(ctx) is None
