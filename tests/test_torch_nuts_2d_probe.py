"""PyTorch port, the 2D NUTS probe (``gpcsd_tpu_torch/nuts_2d_probe.py``, twin
of ``scripts/nuts_2d_probe.py``) at toy sizes on the CPU: the surrogate and
the Hessian against the JAX script's, the artifact, the stop and resume, and
the caches of another seed."""

import importlib.util
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcsd_tpu_torch import nuts_2d_probe as probe

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the toy problem: the Neuropixels geometry at nt=20, 3 trials, ngl 8 x 12
SIZES = {"nt": 20, "ntrials": 3, "ngl1": 8, "ngl2": 12}
TOY = ["--device", "cpu", "--nt", "20", "--ntrials", "3", "--ngl1", "8", "--ngl2", "12",
       "--chains", "2", "--max-depth", "3", "--dense-mass"]
#: the JAX script's artifact fields (``scripts/nuts_2d_probe.py:206-242``)
JAX_FIELDS = {"config", "backend", "samples_per_s_per_chip_median", "median_sampling_chunk_s",
              "mean_leapfrogs_per_sample", "mean_acceptance", "divergences", "max_rhat",
              "min_ess", "min_ess_tail", "step_size"}


def _jax_probe(monkeypatch):
    """``scripts/nuts_2d_probe.py`` with ``scripts/bench_2d.py``'s size
    constants patched to :data:`SIZES`."""
    spec = importlib.util.spec_from_file_location(
        "jax_nuts_2d_probe", os.path.join(ROOT, "scripts", "nuts_2d_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # puts the repository root on sys.path
    import scripts.bench_2d as jb

    for k, v in {"NT": 20, "NTRIALS": 3, "NGL1": 8, "NGL2": 12}.items():
        monkeypatch.setattr(jb, k, v)
    return mod


def test_surrogate_matches_jax(tmp_path, monkeypatch):
    """The same stream (``default_rng(seed)``: z, then the noise) through the
    two packages' covariances: the LFP to 1e-5 of its largest magnitude, the
    sigma2 labels to 1e-12.  The two packages' Ks agree to ~6e-16, but the
    jittered 69 x 69 Ks is ill-conditioned and its Cholesky factors move
    ~1e9 times more (readings 3.0e-7 at seed 3, 1.4e-7 at seed 0; 6.2e-9 in
    1D).  The JAX script writes its cache file; the port's holds also the
    seed and the sizes."""
    os.makedirs(tmp_path / "jax")
    jm = _jax_probe(monkeypatch).build_probe_model(str(tmp_path / "jax"), 3)
    pm = probe.build_probe_model(str(tmp_path), 3, device="cpu", **SIZES)
    jlfp = np.asarray(jm.lfp)
    assert pm.lfp.shape == jlfp.shape == (69, 20, 3)
    err = np.max(np.abs(pm.lfp - jlfp)) / np.max(np.abs(jlfp))
    assert err <= 1e-5, err
    for i in (0, 1):
        a = pm.temporal_cov_list[i].params["sigma2"]["value"]
        b = float(jm.temporal_cov_list[i].params["sigma2"]["value"])
        assert abs(a - b) <= 1e-12 * abs(b)
    assert pm.sig2n["value"] == float(jm.sig2n["value"]) == 0.01
    with np.load(tmp_path / "surrogate_lfp_2d.npz") as d:
        assert {k: int(d[k]) for k in ("seed", *SIZES)} == {"seed": 3, **SIZES}
        np.testing.assert_array_equal(d["lfp"], pm.lfp)


def test_hessian_matches_jax_stencil(tmp_path, monkeypatch):
    """``probe_hessian`` against the JAX prep's ``vmap(grad)`` central
    differences (h = 1e-4) on the same data.  Away from the spatial rows
    (R, ell1, ell2) the two agree to 1e-9 of max |H| (reading 1.1e-11).  The
    spatial part of the gradient carries each eigensolver's placement of the
    Gram's roundoff-level eigenvalues (~5e-5 absolute on |g| ~ 30, ROADMAP
    Queue C), and the stencil divides it by 2h: the spatial rows agree to
    1e-2 of max |H| only (reading 1.3e-3; 1.1e-4 at h = 1e-3, 1.6e-5 at
    1e-2).  The Hessian's step is the JAX prep's all the same."""
    os.makedirs(tmp_path / "jax")
    jm = _jax_probe(monkeypatch).build_probe_model(str(tmp_path / "jax"), 0)
    pm = probe.build_probe_model(str(tmp_path), 0, device="cpu", **SIZES)
    pm.lfp = np.asarray(jm.lfp)
    fns, Y = jm._fns(), jm._Y()
    u0 = jnp.asarray(fns.param_set.pack(jm._theta()))
    dim, h = u0.shape[0], 1e-4
    eye = h * jnp.eye(dim, dtype=u0.dtype)
    pts = jnp.concatenate([u0[None] + eye, u0[None] - eye], axis=0)
    gs = jax.jit(jax.vmap(jax.grad(lambda u: fns.neg_log_joint(u, Y))))(pts)
    want = np.asarray((gs[:dim] - gs[dim:]) / (2 * h), dtype=np.float64).T
    want = 0.5 * (want + want.T)
    path = probe.probe_hessian(pm, str(tmp_path), 0)
    with np.load(path) as d:
        H, u_saved, seed = d["H"], d["u0"], int(d["seed"])
    np.testing.assert_array_equal(u_saved, np.asarray(u0))
    assert seed == 0 and H.shape == (8, 8)
    scale = np.max(np.abs(want))
    err = np.max(np.abs(H - want)) / scale
    err_rest = np.max(np.abs(H[3:, 3:] - want[3:, 3:])) / scale
    assert err <= 1e-2 and err_rest <= 1e-9, (err, err_rest)
    # a second call reuses the file
    mtime = os.path.getmtime(path)
    assert probe.probe_hessian(pm, str(tmp_path), 0) == path and os.path.getmtime(path) == mtime


def _draws(out_dir):
    with np.load(os.path.join(out_dir, "posterior_samples_2d.npz")) as d:
        return {k: d[k] for k in d.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Directory ``a``: prep, then stopped by ``--max-seconds 0`` and rerun
    to the end; ``b``: one uninterrupted run on ``a``'s cached inputs."""
    tmp = tmp_path_factory.mktemp("probe")
    a, b = str(tmp / "a"), str(tmp / "b")
    lengths = ["--warmup", "4", "--samples", "6"]
    rc_prep = probe.main(["--out-dir", a, "--prep-only", *TOY])
    files_after_prep = sorted(os.listdir(a))
    rc_stop = probe.main(["--out-dir", a, "--max-seconds", "0", *TOY, *lengths])
    with open(os.path.join(a, "chunk_timing.json")) as f:
        stopped_at = len(json.load(f))
    artifact_after_stop = os.path.exists(os.path.join(a, "nuts_2d_probe.json"))
    rc_resume = probe.main(["--out-dir", a, "--max-seconds", "0", *TOY, *lengths])
    os.makedirs(b)
    for name in ("surrogate_lfp_2d.npz", "hessian_f64_2d.npz"):
        shutil.copy2(os.path.join(a, name), os.path.join(b, name))
    rc_whole = probe.main(["--out-dir", b, *TOY, *lengths])
    return dict(a=a, b=b, rc=[rc_prep, rc_stop, rc_resume, rc_whole],
                files_after_prep=files_after_prep, stopped_at=stopped_at,
                artifact_after_stop=artifact_after_stop)


def test_stop_and_resume_bit_for_bit(runs):
    """``--prep-only`` writes the two caches and exits 0; ``--max-seconds 0``
    exits 3 at the first saved transition (5 of 10) and writes no artifact;
    the rerun finishes (the last transition never stops) with the
    uninterrupted run's draws bit for bit."""
    assert runs["rc"] == [0, 3, 0, 0]
    assert runs["files_after_prep"] == ["hessian_f64_2d.npz", "surrogate_lfp_2d.npz"]
    assert runs["stopped_at"] == 5 and not runs["artifact_after_stop"]
    a, b = _draws(runs["a"]), _draws(runs["b"])
    assert set(a) == set(b) == {"raw_u", "diag_num_steps", "diag_diverging", "diag_step_size"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["raw_u"].shape == (2, 6, 8) and a["diag_num_steps"].shape == (2, 6)


def test_artifact_fields_and_gate(runs):
    """The JAX script's fields plus ``device``, ``nvidia_smi``, ``healthy``,
    ``gate_failures`` and ``median_sampling_transition_s``; a CPU run of 2 x
    6 draws fails the shared gate, so it publishes no rate."""
    with open(os.path.join(runs["a"], "nuts_2d_probe.json")) as f:
        art = json.load(f)
    assert set(art) == JAX_FIELDS | {"device", "nvidia_smi", "healthy", "gate_failures",
                                     "median_sampling_transition_s"}
    assert art["config"] == {"nx": 69, "nt": 20, "ntrials": 3, "ngl": [8, 12], "chains": 2,
                             "warmup": 4, "samples": 6, "max_depth": 3, "chunk_size": 1,
                             "metric": "dense_mass + map-hessian whitening"}
    assert art["backend"] == art["device"] == "cpu" and art["nvidia_smi"] is None
    assert not art["healthy"] and "device 'cpu' is not an NVIDIA card" in art["gate_failures"]
    assert any("min bulk ESS" in f for f in art["gate_failures"])
    assert art["samples_per_s_per_chip_median"] is None
    assert art["median_sampling_transition_s"] == art["median_sampling_chunk_s"] > 0
    assert len(art["step_size"]) == 2 and art["mean_leapfrogs_per_sample"] >= 1
    with open(os.path.join(runs["a"], "chunk_timing.json")) as f:
        assert sorted(map(int, json.load(f))) == list(range(10))


def test_healthy_run_publishes_its_rate(runs, tmp_path, monkeypatch):
    """Where the shared gate passes (stubbed to pass here: a CPU run of 2 x
    6 draws cannot), a rerun on a copy of the finished directory publishes
    the chains over the median sampling transition."""
    d = str(tmp_path / "a")
    shutil.copytree(runs["a"], d)
    monkeypatch.setattr(probe, "artifact_gate_failures", lambda art: [])
    assert probe.main(["--out-dir", d, *TOY, "--warmup", "4", "--samples", "6"]) == 0
    with open(os.path.join(d, "nuts_2d_probe.json")) as f:
        art = json.load(f)
    with open(os.path.join(d, "chunk_timing.json")) as f:
        samp = [v for k, v in json.load(f).items() if int(k) >= 4]
    assert art["healthy"] and art["gate_failures"] == [] and len(samp) == 6
    assert art["median_sampling_transition_s"] == float(np.median(samp)) > 0
    assert art["samples_per_s_per_chip_median"] == 2 / art["median_sampling_transition_s"]


def test_caches_of_another_seed_are_made_anew(tmp_path):
    """A surrogate or a Hessian cached for another seed is replaced, with a
    warning, by the one the asked seed gives."""
    probe.build_probe_model(str(tmp_path), 0, device="cpu", **SIZES)
    with pytest.warns(UserWarning, match="drawing it anew"):
        m1 = probe.build_probe_model(str(tmp_path), 1, device="cpu", **SIZES)
    os.makedirs(tmp_path / "fresh")
    fresh = probe.build_probe_model(str(tmp_path / "fresh"), 1, device="cpu", **SIZES)
    np.testing.assert_array_equal(m1.lfp, fresh.lfp)
    with np.load(tmp_path / "surrogate_lfp_2d.npz") as d:
        assert int(d["seed"]) == 1
    probe.probe_hessian(m1, str(tmp_path), 0)
    with pytest.warns(UserWarning, match="taking the Hessian anew"):
        path = probe.probe_hessian(m1, str(tmp_path), 1)
    with np.load(path) as d:
        assert int(d["seed"]) == 1


def test_sampler_counts_its_evaluations(tmp_path, monkeypatch):
    """``infer.nuts.evaluations`` (the count the smoke holds the kernel's
    launches to) adds every row ``nuts_chains`` evaluates: the step-size
    search, warmup and sampling; at least the sampling leapfrogs."""
    from gpcsd_tpu_torch.infer import nuts

    rows = []
    original = nuts.value_and_grad_rows

    def counted(fn, z):
        rows.append(z.shape[0])
        return original(fn, z)

    monkeypatch.setattr(nuts, "value_and_grad_rows", counted)
    monkeypatch.setattr(nuts, "evaluations", 0)
    pm = probe.build_probe_model(str(tmp_path), 0, device="cpu", **SIZES)
    post = pm.sample_posterior(n_chains=2, num_warmup=3, num_samples=3, max_depth=3,
                               laplace=False)
    assert nuts.evaluations == sum(rows) > post.diagnostics["num_steps"].sum() > 0
