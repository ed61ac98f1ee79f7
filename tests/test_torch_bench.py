"""PyTorch port, the bench (``gpcsd_tpu_torch/bench.py``, twin of ``bench.py``
and ``scripts/bench_2d.py``) on the CPU: the shared health gate on every case
of ``tests/test_bench_gates.py`` and on the banked artifacts, the bench points
against the JAX package's, the copied numpy baseline against ``bench.py``'s,
and the refusal to run without a card."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcsd_tpu_torch import bench, paper
from gpcsd_tpu_torch.infer.map import value_and_grad

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_RUN = os.path.join(ROOT, "results", "torch_paper_nuts_hetx", "paper_nuts_auditory.json")
TPU_RUN = os.path.join(ROOT, "results", "paper_nuts_hetx", "paper_nuts_auditory.json")


def _load(name, relpath):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_bench = _load("jax_bench", "bench.py")
jax_bench_2d = _load("jax_bench_2d", os.path.join("scripts", "bench_2d.py"))


def _healthy():
    """``tests/test_bench_gates.py``'s healthy artifact, with what the port's
    gate also asks for: no divergence, 100 bulk ESS a chain, an NVIDIA card."""
    return {
        "samples_per_s_per_chip_median": 0.41,
        "mean_leapfrogs_per_sample": 22.0,
        "max_rhat": 1.01,
        "config": {"chains": 4, "warmup": 500, "samples": 500,
                   "max_depth": 7, "chunk_size": 3},
        "divergences": 0,
        "min_ess": 400.0,
        "device": "NVIDIA H100 80GB HBM3",
    }


DROP = object()


# (name, changes to the healthy artifact (None: the empty artifact), passes,
# a phrase of the expected failure).  The first six are tests/test_bench_gates.py's
GATE_CASES = [
    ("healthy", {}, True, None),
    ("round2_frozen_chains", {"max_rhat": 1.2e4}, False, "max_rhat"),
    ("round3_degenerate_leapfrogs", {"mean_leapfrogs_per_sample": 1.0}, False, "degenerate"),
    ("missing_fields", None, False, "no rate"),
    ("missing_rhat", {"max_rhat": None}, False, "max_rhat"),
    ("borderline_rhat_below", {"max_rhat": 1.049}, True, None),
    ("borderline_rhat_above", {"max_rhat": 1.051}, False, "max_rhat"),
    ("nan_rhat", {"max_rhat": float("nan")}, False, "max_rhat"),
    ("one_divergence", {"divergences": 1}, False, "divergences=1"),
    ("divergences_missing", {"divergences": DROP}, False, "divergences=None"),
    ("ess_floor_exact", {"min_ess": 400.0}, True, None),
    ("ess_below_floor", {"min_ess": 399.9}, False, "min bulk ESS"),
    ("ess_floor_scales_with_chains", {"config": {"chains": 8}, "min_ess": 700.0}, False, "< 800"),
    ("ess_missing", {"min_ess": DROP}, False, "min bulk ESS"),
    ("device_missing", {"device": DROP}, False, "not an NVIDIA card"),
    ("device_cpu", {"device": "cpu"}, False, "not an NVIDIA card"),
    ("collapsed_step", {"step_size": [0.3, 1e-4]}, False, "step size"),
    ("nan_step", {"step_size": [float("nan")] * 4}, False, "step size"),
    ("healthy_steps", {"step_size": [0.3, 0.25, 0.31, 0.28]}, True, None),
    ("zero_rate", {"samples_per_s_per_chip_median": 0.0}, False, "no rate"),
]


@pytest.mark.parametrize("name, changes, passes, reason", GATE_CASES,
                         ids=[c[0] for c in GATE_CASES])
def test_artifact_gate(name, changes, passes, reason):
    if changes is None:
        art = {}
    else:
        art = _healthy()
        for k, v in changes.items():
            if v is DROP:
                del art[k]
            else:
                art[k] = v
    failures = bench.artifact_gate_failures(art)
    got = bench.artifact_nuts_rate(art)
    if passes:
        assert failures == [] and got is not None
        assert got.rate == art["samples_per_s_per_chip_median"]
        assert got.steps == art["mean_leapfrogs_per_sample"] and got.max_rhat == art["max_rhat"]
        assert "max_depth=7" in got.source and "4x(500+500)" in got.source
        assert (got.max_depth, got.chunk_size) == (7, 3)  # from the artifact's config
    else:
        assert got is None
        assert any(reason in f for f in failures), failures


def test_banked_torch_run_passes_and_tpu_run_is_refused(capsys):
    """The port's banked paper run publishes its numbers (11.43 draws/s, 7.0
    leapfrogs, max_depth 7, chunk_size 1); every banked TPU run is refused
    by its content; the default paths never name a TPU run."""
    with open(TORCH_RUN) as f:
        line = bench.artifact_nuts_rate(json.load(f))
    assert line is not None and abs(line.rate - 11.43) < 0.01 and line.steps == 7.0
    assert (line.max_depth, line.chunk_size, line.divergences) == (7, 1, 0)
    assert abs(line.max_rhat - 1.0064) < 1e-4
    assert bench.bench_nuts(1.0) == line  # the artifact route: no live run
    for path in jax_bench.PAPER_RUNS:
        if os.path.isfile(path):
            with open(path) as f:
                assert any("not an NVIDIA card" in r
                           for r in bench.artifact_gate_failures(json.load(f))), path
    assert bench.PAPER_RUNS == [TORCH_RUN]
    # a refused artifact is reported and the next one is read
    assert bench.bench_nuts(1.0, paths=[TPU_RUN, TORCH_RUN]) == line
    note = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert note["path"] == os.path.join("results", "paper_nuts_hetx", "paper_nuts_auditory.json")
    assert "device None is not an NVIDIA card" in note["reasons"]


@pytest.mark.parametrize("entry", ["main", "main_2d"])
def test_main_refuses_without_card(entry, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert getattr(bench, entry)() != 0
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and captured.out == ""


def test_bench_point_value_and_grad_match_jax():
    """``build_problem`` against ``bench.py``'s JAX model at the bench point
    and two jittered points: value 1e-9 relative, gradient 1e-4 in norm and
    1e-6 on its temporal part (the port's limits at the paper configuration:
    the spatial part carries ~1e-5 of eigensolver-dependent bias)."""
    jm, pm = jax_bench.build_problem(), bench.build_problem(device="cpu")
    np.testing.assert_array_equal(np.asarray(jm.lfp), pm.lfp)
    jfns, jY = jm._fns(), jm._Y()
    pfns, pY = pm._fns(), pm._Y()
    assert pfns.param_set.names_flat() == list(jfns.param_set.names_flat())
    temporal = [i for i, n in enumerate(pfns.param_set.names_flat()) if n.startswith("tm")]
    vg = jax.jit(jax.value_and_grad(jfns.neg_log_joint))
    us = bench.bench_points(pm, 3)
    us[0] = np.asarray(jfns.param_set.pack(jm._theta()))
    for u in us:
        fj, gj = vg(jnp.asarray(u), jY)
        fj, gj = float(fj), np.asarray(gj)
        fp, gp = value_and_grad(lambda ut: pfns.neg_log_joint(ut, pY), u, "cpu")
        assert abs(fp - fj) <= 1e-9 * abs(fj)
        assert np.linalg.norm(gp - gj) <= 1e-4 * np.linalg.norm(gj)
        assert np.linalg.norm(gp[temporal] - gj[temporal]) <= 1e-6 * np.linalg.norm(gj[temporal])


def test_bench_points_are_bench_py_points():
    pm = bench.build_problem(device="cpu")
    u0 = pm._fns().param_set.pack(pm._theta()).numpy()
    want = u0[None, :] + 0.01 * np.random.default_rng(1).normal(size=(50, u0.size))
    np.testing.assert_array_equal(bench.bench_points(pm, 50), want)
    assert len(np.unique(want, axis=0)) == 50


def test_numpy_baseline_bit_for_bit(monkeypatch):
    """The copied baseline on the port's model gives ``bench.py``'s inputs
    and values bit for bit: ``bench.py``'s ``bench_baseline`` is run with its
    ``reference_style_loglik_numpy`` recorded."""
    calls = []
    original = jax_bench.reference_style_loglik_numpy

    def recorded(theta, *args):
        out = original(theta, *args)
        calls.append((theta, args, out))
        return out

    monkeypatch.setattr(jax_bench, "reference_style_loglik_numpy", recorded)
    assert jax_bench.bench_baseline(jax_bench.build_problem(), n_iters=2) > 0
    thetas, args = bench.baseline_inputs(bench.build_problem(device="cpu"), n_iters=2)
    assert [c[0] for c in calls] == [thetas[0], *thetas]
    for theta, jargs, jout in calls:
        for a, b in zip(args, jargs):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert bench.reference_style_loglik_numpy(theta, *args) == jout
    assert np.isfinite(calls[-1][2])


def test_nuts_problem_lfp_matches_jax(monkeypatch):
    """``build_nuts_problem`` against ``bench.py``'s at nt=60, 8 trials (the
    sizes patched in both modules; the JAX einsum over all trials at nt=600
    is minutes): the same stream, so the LFP agrees to 1e-7 of its largest
    magnitude.  The two packages' Ks agree to 3.7e-16, but the jittered Ks
    has condition number 2.2e10, and its Cholesky factors differ by 4.2e-9
    (6.2e-9 in the LFP); the temporal sigma2 labels agree to 1e-12."""
    for mod in (jax_bench, bench):
        monkeypatch.setattr(mod, "NT", 60)
        monkeypatch.setattr(mod, "NTRIALS", 8)
    jm, pm = jax_bench.build_nuts_problem(), bench.build_nuts_problem(device="cpu")
    assert pm.lfp.shape == np.asarray(jm.lfp).shape == (24, 60, 8)
    err = np.max(np.abs(pm.lfp - np.asarray(jm.lfp))) / np.max(np.abs(jm.lfp))
    assert err <= 1e-7, err
    for i in (0, 1):
        a = pm.temporal_cov_list[i].params["sigma2"]["value"]
        b = float(jm.temporal_cov_list[i].params["sigma2"]["value"])
        assert abs(a - b) <= 1e-12 * abs(b)
    assert pm.sig2n["value"] == 0.01


def test_live_route_reports_rate_or_reasons(monkeypatch):
    """The live route on a small surrogate (nt=40, 6 trials, 4 x (6 + 6)):
    either a rate with every gate passed or None with the reasons; the line
    carries the run's own max_depth and chunk_size."""
    monkeypatch.setattr(bench, "NT", 40)
    monkeypatch.setattr(bench, "NTRIALS", 6)
    monkeypatch.setattr(bench, "NUTS_WARMUP", 6)
    monkeypatch.setattr(bench, "NUTS_SAMPLES", 6)
    line = bench.bench_nuts(1.0, paths=[], device="cpu")
    assert (line.max_depth, line.chunk_size) == (7, 1)
    assert line.source.startswith("live 4x(6+6)")
    assert (line.rate is None) == bool(line.failures)
    if line.rate is None:
        assert "FAILED HEALTH GATES" in line.source
    else:
        assert line.rate > 0 and line.divergences == 0 and 0.6 <= line.accept <= 0.95
    assert np.isfinite(line.steps) and line.steps >= 1


def test_bench_evals_per_s_counts_on_cpu(monkeypatch):
    """The timing loop on the bench point cut to nt=40, 5 trials, on the
    CPU: every figure present, the counted evaluations, no event timing and
    no kernel launch off the card."""
    monkeypatch.setattr(bench, "NT", 40)
    monkeypatch.setattr(bench, "NTRIALS", 5)
    pm = bench.build_problem(device="cpu")
    res = bench.bench_evals_per_s(pm, n_iters=4, repeats=3, warmup=2)
    assert res["evals"] == 2 + 3 * 4 and res["launches"] == 0
    assert res["q25"] <= res["median"] <= res["q75"] and res["median"] > 0
    assert res["event_ms_per_eval"] is None and len(res["repeats"]) == 3
    assert res["points"].shape == (4, 7) and np.isfinite(res["value"]) and res["first_call_s"] > 0
    f_last, _ = value_and_grad(lambda ut: pm._fns().neg_log_joint(ut, pm._Y()), res["points"][-1],
                               "cpu")
    assert res["value"] == f_last


def test_2d_point_matches_bench_2d(monkeypatch):
    """``paper.neuropixels_problem`` (the 2D bench's point) against
    ``scripts/bench_2d.py``'s at nt=30, 4 trials, ngl 8 x 12: the same LFP,
    the spatial covariance to 1e-14 of its largest entry (reading 5.6e-16),
    ``neg_log_joint`` at the point to 1e-5 relative.  The value cannot be
    held closer: the 69 x 69 Gram (norm 1.1e9) has eigenvalues at its
    roundoff (+-1e-6), which the two packages' eigensolvers place
    differently, and times Kt's eigenvalues they move D = ls lt + 0.1
    (ROADMAP Queue C); readings 5.2e-7 here, 6.7e-7 at ngl 15 x 40, 1.6e-6
    at 30 x 120.  The 2D timing loop and the numpy baseline run."""
    for k, v in {"NT": 30, "NTRIALS": 4, "NGL1": 8, "NGL2": 12}.items():
        monkeypatch.setattr(jax_bench_2d, k, v)
    jm = jax_bench_2d.build_problem()
    pm = paper.neuropixels_problem(0, nt=30, ntrials=4, ngl1=8, ngl2=12, device="cpu")
    np.testing.assert_array_equal(np.asarray(jm.lfp), pm.lfp)
    jfns, pfns = jm._fns(), pm._fns()
    ks_jax = np.asarray(jfns.build_ks(jm._theta()))
    with torch.no_grad():
        ks_port = pfns.build_ks(pm._theta()).numpy()
    assert np.max(np.abs(ks_port - ks_jax)) <= 1e-14 * np.max(np.abs(ks_jax))
    u0 = np.asarray(jfns.param_set.pack(jm._theta()))
    want = float(jfns.neg_log_joint(jnp.asarray(u0), jm._Y()))
    with torch.no_grad():
        got = float(pfns.neg_log_joint(torch.tensor(u0), pm._Y()))
    assert abs(got - want) <= 1e-5 * abs(want)
    res = bench.bench_2d(pm, n_iters=3, repeats=2)
    assert res["evals"] == 3 + 2 * 3 and np.isfinite(res["value"]) and res["median"] > 0
    assert bench.bench_baseline_2d(pm, n_iters=1) > 0
