"""``scripts/torch_posterior_accuracy.py`` (the port's posterior-moment gate)
against the JAX package's ``scripts/posterior_accuracy.py`` on two synthetic
run directories of seeded draws: the z per parameter, ``max_z``, ``pass``
and the truth coverage to 1e-12, the exit code following the gate, and a
default output outside the JAX script's ``results/posterior_accuracy/``.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["R", "ell", "tm0_sigma2", "sig2n[0]", "sig2n[1]"]


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_run(path, seed, shift):
    """A run directory: raw_u (3 chains, 300 draws, 5) of AR(1) draws whose
    third parameter's mean is moved by ``shift``, and an artifact with its
    parameter names and constrained summaries."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(3, 300, len(NAMES)))
    u = np.empty_like(e)
    u[:, 0] = e[:, 0]
    for i in range(1, 300):
        u[:, i] = 0.6 * u[:, i - 1] + 0.8 * e[:, i]
    u[..., 2] += shift
    os.makedirs(path)
    np.savez(os.path.join(path, "posterior_samples.npz"), raw_u=u)
    art = {"rhat": {n: 1.0 for n in NAMES}, "backend": "cpu", "max_rhat": 1.01, "min_ess": 400.0,
           "divergences": 0, "truth": {"R": 150.0, "ell": 300.0, "sig2n": [0.1, 0.2]},
           "posterior_mean": {"R": 152.0 + seed, "ell": 290.0, "sig2n": [0.11, 0.19]},
           "posterior_sd": {"R": 4.0, "ell": 20.0, "sig2n": [0.01, 0.0]}}
    with open(os.path.join(path, "paper_nuts_auditory.json"), "w") as f:
        json.dump(art, f)
    return str(path)


@pytest.mark.parametrize("shift", [0.02, 0.6])
def test_matches_the_jax_script(shift, tmp_path, monkeypatch):
    run = _write_run(tmp_path / "run", 1, shift)
    control = _write_run(tmp_path / "control", 2, 0.0)
    jax_out, port_out = str(tmp_path / "jax.json"), str(tmp_path / "port" / "acceptance.json")
    monkeypatch.setattr(sys, "argv", ["posterior_accuracy.py", "--tpu", run, "--cpu", control,
                                      "--out", jax_out])
    jax_rc = _script("posterior_accuracy").main()
    rc = _script("torch_posterior_accuracy").main(["--run", run, "--control", control,
                                                    "--out", port_out])
    with open(jax_out) as f:
        want = json.load(f)
    with open(port_out) as f:
        got = json.load(f)
    assert rc == jax_rc == (0 if want["pass"] else 1)
    assert got["pass"] == want["pass"] == (shift < 0.1)
    assert got["max_z"] == pytest.approx(want["max_z"], rel=1e-12, abs=0.0)
    assert got["z_scores_u_space"].keys() == want["z_scores_u_space"].keys()
    for n, z in want["z_scores_u_space"].items():
        assert got["z_scores_u_space"][n] == pytest.approx(z, rel=1e-12, abs=1e-300)
    assert got["truth_coverage_z"].keys() == want["truth_coverage_z"].keys()
    for k, zs in want["truth_coverage_z"].items():
        np.testing.assert_allclose(got["truth_coverage_z"][k], zs, rtol=1e-12, atol=0.0)
    assert got["run_health"] == want["tpu_health"] and got["control_health"] == want["cpu_health"]


def test_default_out_is_not_the_banked_acceptance():
    mod = _script("torch_posterior_accuracy")
    banked = os.path.join("results", "posterior_accuracy")
    assert not os.path.normpath(mod.DEFAULT_OUT).startswith(banked + os.sep)
    assert mod.DEFAULT_OUT.startswith("results/torch_posterior_accuracy/")


def test_refuses_runs_of_other_parameters(tmp_path):
    run = _write_run(tmp_path / "run", 1, 0.0)
    control = tmp_path / "control"
    _write_run(control, 2, 0.0)
    np.savez(control / "posterior_samples.npz", raw_u=np.zeros((2, 10, 4)))
    with pytest.raises(ValueError, match="parameter names"):
        _script("torch_posterior_accuracy").accuracy(run, str(control))
