"""PyTorch port, the paper run (``gpcsd_tpu_torch/paper_run.py`` and its
command line ``scripts/torch_paper_nuts_run.py``) at toy lengths on the CPU:
the stops with exit code 3 inside the MAP stage and in the sampler, the
completion from the saved state, the equality with an uninterrupted run, and
the artifact's schema against the banked JAX run's.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpcsd_tpu_torch import bench, paper_run

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANKED = os.path.join(ROOT, "results", "paper_nuts_hetx")
#: nt = 20 in the baseline window, 3 trials, 2 chains x (6 + 4)
TOY = ["--device", "cpu", "--ntime", "40", "--ntrials", "3", "--chains", "2", "--warmup", "6",
       "--samples", "4", "--restarts", "2", "--map-maxiter", "5", "--polish-maxiter", "5"]
INPUTS = ("surrogate_lfp.npz", "map_params.pkl", "mode_params.pkl", "hessian_f64.npz")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Directory ``a``: stopped twice through the command line (inside the
    MAP stage, then in the sampler), then finished in process; directory
    ``b``: one uninterrupted run on ``a``'s cached inputs; directory ``c``:
    an uninterrupted MAP stage on ``a``'s surrogate."""
    tmp = tmp_path_factory.mktemp("paper_run")
    a, b, c = str(tmp / "a"), str(tmp / "b"), str(tmp / "c")

    def stopped_run():
        return subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", "torch_paper_nuts_run.py"),
             "--out-dir", a, "--max-seconds", "0", *TOY],
            capture_output=True, text=True, cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "2"})

    stop_map = stopped_run()
    after_map_stop = sorted(os.listdir(a))
    stop = stopped_run()
    after_stop = sorted(os.listdir(a))
    rc_resume = paper_run.main(["--out-dir", a, *TOY])
    os.makedirs(b)
    for name in INPUTS:
        shutil.copy2(os.path.join(a, name), os.path.join(b, name))
    rc_whole = paper_run.main(["--out-dir", b, *TOY])
    os.makedirs(c)
    shutil.copy2(os.path.join(a, "surrogate_lfp.npz"), os.path.join(c, "surrogate_lfp.npz"))
    paper_run.fit_map(paper_run.build_model(c, 40, 3, 0, "cpu"), c, restarts=2, maxiter=5, seed=0)
    return {"a": a, "b": b, "c": c, "stop_map": stop_map, "after_map_stop": after_map_stop,
            "stop": stop, "after_stop": after_stop, "rc_resume": rc_resume, "rc_whole": rc_whole}


def test_stop_inside_the_map_stage_exits_3_with_its_state(runs):
    """``--max-seconds 0`` stops the MAP fit at its first checkpoint: exit
    code 3, the optimizer's state on disk and no MAP pickle yet; the rerun
    continues the fit and goes on to the sampler."""
    stop = runs["stop_map"]
    assert stop.returncode == 3, stop.stderr[-2000:]
    assert "MAP stage: L-BFGS paused at iteration 3" in stop.stdout
    assert runs["after_map_stop"] == ["map_state.npz", "map_state.structure.pkl",
                                      "surrogate_lfp.npz"]
    assert "MAP: restored from cache" not in runs["stop"].stdout
    assert "MAP: fitted" in runs["stop"].stdout


def test_resumed_map_equals_uninterrupted_fit(runs):
    """The MAP parameters of the stopped and resumed stage equal, bit for
    bit, those of one uninterrupted fit on the same surrogate."""
    def params(d):
        with open(os.path.join(d, "map_params.pkl"), "rb") as f:
            return pickle.load(f)

    got, want = params(runs["a"]), params(runs["c"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_stop_exits_3_at_a_saved_transition(runs):
    stop = runs["stop"]
    assert stop.returncode == 3, stop.stderr[-2000:]
    assert "time budget reached" in stop.stdout and "MAP: fitted" in stop.stdout
    # every stage's cache and the sampler's state are there; no artifact yet
    assert set(INPUTS) <= set(runs["after_stop"])
    assert {"nuts_state.npz", "nuts_state.structure.pkl", "chunk_timing.json"} <= set(runs["after_stop"])
    assert "paper_nuts_auditory.json" not in runs["after_stop"]
    assert not [n for n in runs["after_stop"] if n.endswith(".tmp")]


def test_rerun_completes_and_equals_uninterrupted_run(runs):
    """Exit code 0 from the saved state (the cached stages are not redone),
    and every array of ``posterior_samples.npz`` equal bit for bit to the
    uninterrupted run's."""
    assert runs["rc_resume"] == 0 and runs["rc_whole"] == 0
    with open(os.path.join(runs["a"], "chunk_timing.json")) as f:
        assert sorted(map(int, json.load(f))) == list(range(10))
    with np.load(os.path.join(runs["a"], "posterior_samples.npz")) as da, \
            np.load(os.path.join(runs["b"], "posterior_samples.npz")) as db:
        assert set(da.files) == set(db.files)
        for k in da.files:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
        assert da["raw_u"].shape == (2, 4, 30) and da["sig2n"].shape == (8, 24)
        assert da["diag_inv_mass"].shape == (2, 30, 30)
    # a third call on the finished directory samples nothing and rewrites the artifact
    assert paper_run.main(["--out-dir", runs["a"], *TOY]) == 0


def test_artifact_schema_matches_banked_run(runs):
    """The JSON's keys are the banked JAX run's apart from ``backend`` /
    ``n_devices`` (here ``device`` / ``nvidia_smi``), plus ``vs_banked``,
    ``healthy`` and ``gate_failures``; the nested dicts carry the same
    parameter names; the draws file holds the banked file's arrays.  A CPU
    run of 2 x 4 draws fails the shared health gate, so it publishes no
    rate."""
    with open(os.path.join(runs["a"], "paper_nuts_auditory.json")) as f:
        art = json.load(f)
    with open(os.path.join(BANKED, "paper_nuts_auditory.json")) as f:
        banked = json.load(f)
    assert set(art) - set(banked) == {"device", "nvidia_smi", "vs_banked", "healthy",
                                      "gate_failures"}
    assert set(banked) - set(art) == {"backend", "n_devices"}
    assert set(art["config"]) == set(banked["config"])
    assert art["config"] == {**banked["config"], "nt": 20, "ntrials": 3, "chains": 2, "warmup": 6,
                             "samples": 4, "chunk_size": 1}
    for key in ("rhat", "ess", "ess_tail", "posterior_mean", "posterior_sd", "truth",
                "posterior_quantiles"):
        assert set(art[key]) == set(banked[key]), key
    assert art["posterior_quantiles"]["R"].keys() == banked["posterior_quantiles"]["R"].keys()
    assert art["device"] == "cpu" and art["nvidia_smi"] is None
    assert isinstance(art["healthy"], bool) and len(art["step_size"]) == 2
    assert art["gate_failures"] == bench.artifact_gate_failures({**art, "samples_per_s_per_chip_median": 1.0})
    assert not art["healthy"] and "device 'cpu' is not an NVIDIA card" in art["gate_failures"]
    assert art["samples_per_s_per_chip_median"] is None and art["samples_per_s_per_chip_wall"] is None
    assert art["median_sampling_chunk_s"] > 0 and art["total_chunk_wall_s"] > 0
    # the comparison with the banked posterior: one z per parameter, from
    # both runs' means, sds and bulk ESS
    assert set(art["vs_banked"]) == set(banked["rhat"])
    z = art["vs_banked"]["tm0_sigma2"]
    assert np.isclose(z["z"], (z["mean"] - z["banked_mean"]) / z["mc_error"]) and z["mc_error"] > 0
    with np.load(os.path.join(BANKED, "posterior_samples.npz")) as d:
        assert np.isclose(z["banked_mean"], d["raw_u"][..., 3].mean())
        with np.load(os.path.join(runs["a"], "posterior_samples.npz")) as mine:
            assert set(d.files) <= set(mine.files)


def test_healthy_run_publishes_its_rates(runs, tmp_path, monkeypatch):
    """Where the shared gate passes (a CPU run of 2 x 4 draws cannot, so the
    gate is stubbed to pass here), a rerun on a copy of the finished
    directory publishes the chains over the median sampling transition and
    the sampling draws over the summed sampling transitions."""
    d = str(tmp_path / "a")
    shutil.copytree(runs["a"], d)
    monkeypatch.setattr(paper_run, "artifact_gate_failures", lambda art: [])
    assert paper_run.main(["--out-dir", d, *TOY]) == 0
    with open(os.path.join(d, "paper_nuts_auditory.json")) as f:
        art = json.load(f)
    with open(os.path.join(d, "chunk_timing.json")) as f:
        samp = [v for k, v in json.load(f).items() if int(k) >= 6]
    assert art["healthy"] and art["gate_failures"] == [] and len(samp) == 4
    assert art["median_sampling_chunk_s"] == float(np.median(samp)) > 0
    assert art["samples_per_s_per_chip_median"] == 2 / art["median_sampling_chunk_s"]
    assert art["samples_per_s_per_chip_wall"] == pytest.approx(2 * 4 / sum(samp), rel=1e-12)
    assert art["samples_per_s_per_chip_wall"] > 0


def test_vs_banked_absent_or_other_size(tmp_path):
    u = np.random.default_rng(0).normal(size=(2, 50, 3))
    assert paper_run.vs_banked(u, ["a", "b", "c"], "") is None
    assert paper_run.vs_banked(u, ["a", "b", "c"], str(tmp_path / "none.npz")) is None
    assert paper_run.vs_banked(u, ["a", "b", "c"], os.path.join(BANKED, "posterior_samples.npz")) is None
    path = str(tmp_path / "same.npz")
    np.savez(path, raw_u=u)
    same = paper_run.vs_banked(u, ["a", "b", "c"], path)
    assert [same[k]["z"] for k in "abc"] == [0.0, 0.0, 0.0]
