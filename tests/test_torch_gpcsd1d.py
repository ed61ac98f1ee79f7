"""PyTorch port, model layer and the slice end to end: ParamSet, GPCSD1D,
the log-joint and its gradient, the scipy MAP fit, and the auditory paper
configuration, against the JAX package on CPU float64 and against the
banked paper posterior.
"""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpcsd_tpu as g
import gpcsd_tpu_torch as gt
from gpcsd_tpu.infer.map import map_fit as j_map_fit
from gpcsd_tpu.infer.map import sample_restarts as j_sample_restarts
from gpcsd_tpu_torch import config, convert, paper
from gpcsd_tpu_torch.infer.map import map_fit as t_map_fit

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLD = np.load(os.path.join(HERE, "goldens", "reference_goldens.npz"))
with open(os.path.join(HERE, "goldens", "reference_scalars.json")) as f:
    SCAL = json.load(f)
HETX = os.path.join(ROOT, "results", "paper_nuts_hetx")


def np_theta(jm):
    return {k: np.asarray(v) for k, v in jm._theta().items()}


def port_of(jm, **kw):
    """Port GPCSD1D with the JAX model's data, geometry, priors and values
    (the default priors come from the same geometry heuristics)."""
    sig2n_prior = jm.sig2n["prior"]
    if isinstance(sig2n_prior, list):
        sig2n_prior = [gt.HalfNormal(p.sd) for p in sig2n_prior]
    else:
        sig2n_prior = gt.HalfNormal(sig2n_prior.sd)
    return convert.model_from_reference_params(
        jm.lfp, jm.x, jm.t, np_theta(jm), a=jm.a, b=jm.b, ngl=jm.ngl,
        sig2n_prior=sig2n_prior, het_noise=jm.het_noise, **kw,
    )


def value_grad(fn, u):
    ut = torch.tensor(np.asarray(u), dtype=torch.float64, requires_grad=True)
    f = fn(ut)
    (gr,) = torch.autograd.grad(f, ut)
    return float(f.detach()), gr.numpy()


class TestPackage:
    def test_imports_no_jax(self):
        """The card has no JAX: importing the port must not load it."""
        code = (
            "import sys, gpcsd_tpu_torch, gpcsd_tpu_torch.paper, gpcsd_tpu_torch.convert; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gpcsd_tpu')))"
        )
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             cwd=ROOT, check=True).stdout
        assert out.strip() == "[]"
        pat = re.compile(r"^\s*(import|from)\s+(jax|gpcsd_tpu)\b", re.M)
        for dirpath, dirs, files in os.walk(os.path.join(ROOT, "gpcsd_tpu_torch")):
            dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not sources
            for name in files:
                if name.endswith(".py"):
                    with open(os.path.join(dirpath, name)) as f:
                        assert not pat.search(f.read()), name

    def test_get_device(self):
        assert config.get_device("cpu") == torch.device("cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                config.get_device("cuda")
            with pytest.raises(RuntimeError, match="CUDA"):
                gt.GPCSD1D(np.zeros((3, 4, 1)), np.arange(3.0), np.arange(4.0), device="cuda")


def small_jax_model(seed=0, nx=8, nt=15, ntrials=3, het=False, het_noise="approx"):
    rng = np.random.default_rng(seed)
    x = (np.arange(nx) * 100.0).reshape(-1, 1)
    t = np.arange(nt).reshape(-1, 1) * 1.0
    kw = {"sig2n_prior": [g.HalfNormal(0.1) for _ in range(nx)]} if het else {}
    m = g.GPCSD1D(rng.normal(size=(nx, nt, ntrials)), x, t, ngl=40, het_noise=het_noise, **kw)
    m.R["value"] = 120.0
    m.spatial_cov.params["ell"]["value"] = 180.0
    m.temporal_cov_list[0].params["ell"]["value"] = 5.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 0.8
    m.temporal_cov_list[1].params["ell"]["value"] = 2.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.4
    m.sig2n["value"] = rng.uniform(0.01, 0.1, size=nx) if het else 0.05
    return m


class TestParamsAndConvert:
    @pytest.mark.parametrize("het", [False, True], ids=["scalar", "per_channel"])
    def test_param_set_matches_jax(self, het):
        """Same names, order, bounds, packing and prior density (rtol 1e-13:
        logs and exps of the same float64 numbers)."""
        jm = small_jax_model(het=het)
        tm = port_of(jm)
        jp, tp = jm._param_set(), tm._param_set()
        assert tp.names_flat() == jp.names_flat()
        for a, b in zip(tp.bounds(), jp.bounds()):
            np.testing.assert_array_equal(a, b)
        u = np.array(jp.pack(jm._theta()))
        np.testing.assert_allclose(tp.pack(tm._theta()).numpy(), u, rtol=1e-13)
        jt, tt = jp.unpack(jnp.asarray(u + 0.1)), tp.unpack(torch.as_tensor(u + 0.1))
        for k in jt:
            np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]), rtol=1e-13)
        assert np.isclose(float(tp.log_prior(tt)), float(jp.log_prior(jt)), rtol=1e-13)
        assert np.isclose(float(tp.log_det_jacobian(torch.as_tensor(u))),
                          float(jp.log_det_jacobian(jnp.asarray(u))), rtol=1e-13)
        lo, hi = tp.bounds()
        draw = tp.pack(tp.sample(np.random.default_rng(0)))
        clipped = tp.clip_to_bounds(draw).numpy()
        assert np.all(clipped >= lo) and np.all(clipped <= hi)

    def test_fixed_R_objective_matches_jax(self):
        """fix_R drops R from u and adds its constant prior mass, as in the
        JAX package (rtol 1e-12: same f64 algorithm on a small problem)."""
        jm = small_jax_model(seed=1, het=True)
        tm = port_of(jm)
        jf, tf = jm._fns(fix_R=True), tm._fns(fix_R=True)
        assert tf.param_set.names == jf.param_set.names
        u = np.array(jf.param_set.pack(jm._theta()))
        want = float(jf.neg_log_joint(jnp.asarray(u), jm._Y()))
        got = float(tf.neg_log_joint(torch.as_tensor(u), tm._Y()))
        assert np.isclose(got, want, rtol=1e-12)

    def test_theta_schemas_agree(self):
        jm = small_jax_model(het=True)
        a = convert.theta_from_numpy(np_theta(jm))
        b = convert.theta_from_numpy(jm.extract_model_params())
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
        tm = port_of(jm)
        for k, v in tm._theta().items():
            np.testing.assert_array_equal(v.numpy(), a[k].numpy())
        params = tm.extract_model_params()
        tm.restore_model_params(params)
        assert tm.extract_model_params()["temporal_ell_list"] == params["temporal_ell_list"]


def golden_models(het):
    """The golden-suite GPCSD1D (``tests/test_reference_golden.py``)."""
    xs = np.linspace(0.0, 700.0, 8)[:, None]
    ts = np.arange(12.0)[:, None]
    scov = gt.GPCSD1DSpatialCovSE(xs, a=-200.0, b=900.0, ngl=24)
    scov.params["ell"]["value"] = 200.0
    tse, tma = gt.GPCSDTemporalCovSE(ts), gt.GPCSDTemporalCovMatern(ts)
    tse.params["ell"]["value"], tse.params["sigma2"]["value"] = 7.0, 1.1
    tma.params["ell"]["value"], tma.params["sigma2"]["value"] = 2.5, 0.6
    kw = {"sig2n_prior": [gt.HalfNormal(0.1) for _ in range(8)]} if het else {}
    m = gt.GPCSD1D(GOLD["m1_Y"], xs, ts, a=-200.0, b=900.0, ngl=24,
                   spatial_cov=scov, temporal_cov_list=[tse, tma], **kw)
    m.R["value"] = 150.0
    m.sig2n["value"] = GOLD["ceD_sig2n_vec"] if het else 0.05
    return m


class TestGoldens:
    @pytest.mark.parametrize("het,key", [(False, "m1_loglik_hom"), (True, "m1_loglik_het")])
    def test_loglik(self, het, key):
        assert np.isclose(golden_models(het).loglik(), SCAL[key], rtol=1e-8)

    def test_bounds_and_prior(self):
        m = golden_models(False)
        assert np.isclose(m.R["min"], SCAL["m1_R_min"]) and np.isclose(m.R["max"], SCAL["m1_R_max"])
        assert np.isclose(m.R["prior"].alpha, SCAL["m1_R_prior_alpha"])
        assert np.isclose(m.R["prior"].beta, SCAL["m1_R_prior_beta"])
        assert np.isclose(m.sig2n["min"], SCAL["m1_sig2n_min"])
        assert np.isclose(m.sig2n["max"], SCAL["m1_sig2n_max"])


def bench_problem():
    """The JAX headline benchmark's point (``bench.py`` ``build_problem``):
    nx=24, nt=600, 100 trials, ngl=100, scalar noise."""
    rng = np.random.default_rng(0)
    m = g.GPCSD1D(rng.normal(size=(24, 600, 100)), (np.arange(24) * 100.0).reshape(-1, 1),
                  np.arange(600).reshape(-1, 1) * 1.0, ngl=100)
    m.R["value"] = 150.0
    m.spatial_cov.params["ell"]["value"] = 200.0
    m.temporal_cov_list[0].params["ell"]["value"] = 8.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    m.temporal_cov_list[1].params["ell"]["value"] = 3.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
    m.sig2n["value"] = 0.05
    return m


@pytest.mark.parametrize("fn", ["neg_log_joint", "log_prob"])
def test_log_joint_matches_jax_at_bench_point(fn):
    """Value and gradient at the bench point and 10 jittered points.

    The value (~6e6, a difference of the logdet and quadratic terms) agrees
    to rtol 1e-9: measured up to 3e-10, because MKL's eigh (torch) and
    JAX's LAPACK eigh resolve the deep, jitter-level spatial modes
    differently.  The gradient agrees to 1e-6 relative in norm (measured
    up to 2e-9 here)."""
    jm = bench_problem()
    tm = port_of(jm)
    jf, tf = getattr(jm._fns(), fn), getattr(tm._fns(), fn)
    Yj, Yt = jm._Y(), tm._Y()
    u0 = np.asarray(jm._fns().param_set.pack(jm._theta()))
    us = np.vstack([u0, u0 + 0.01 * np.random.default_rng(1).normal(size=(10, u0.size))])
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jf), (0, None)))(jnp.asarray(us), Yj)
    for u, v_want, g_want in zip(us, np.asarray(jv), np.asarray(jg)):
        v, gr = value_grad(lambda ut: tf(ut, Yt), u)
        assert np.isclose(v, v_want, rtol=1e-9, atol=0.0)
        assert np.linalg.norm(gr - g_want) <= 1e-6 * np.linalg.norm(g_want)


@pytest.fixture(scope="module")
def paper_case():
    lfp, time_ms, _ = paper.paper_surrogate(0, 1200, 100)
    model = paper.build_model(lfp, time_ms, het_noise="exact")
    draws = np.load(os.path.join(HETX, "posterior_samples.npz"))["raw_u"].reshape(-1, 30)[:8]
    logp64 = np.load(os.path.join(HETX, "logp64_draws.npy"))[:8]
    return model, draws, logp64


def test_paper_log_prob_matches_banked_draws(paper_case):
    """The port's own surrogate (no JAX anywhere in it) reproduces the JAX
    CPU-f64 log_prob banked at the first 8 draws of the paper posterior to
    1e-8 relative (measured: ~1.5e-11, from the surrogate's Cholesky of the
    strongly graded Ks).

    The gradient matches ``jax.grad(fns.log_prob)`` on the same data to
    1e-4 relative in norm.  It cannot be held tighter: at this
    configuration the R and spatial-ell components go through eigenvalue
    pairs whose gap is near the regularization eps of eigh_safe, so they
    move by ~1e-5 relative with the LAPACK build (torch's MKL eigh against
    scipy's: 7.6e-6 in norm at the first draw), and both packages' values
    sit ~1e-5 from a finite-difference gradient of the (eigensolver-stable,
    ~1e-16) value.  The per-channel noise components go through the same
    whitened spatial eigh.  The four temporal components go through Kt's
    eigh only and are held to 1e-6."""
    model, draws, logp64 = paper_case
    fns, Y = model._fns(), model._Y()
    jm = g.GPCSD1D(
        model.lfp, model.x, model.t, a=model.a, b=model.b,
        spatial_cov=g.GPCSD1DSpatialCovSE(model.x, a=model.a, b=model.b),
        temporal_cov_list=[g.GPCSDTemporalCovSE(model.t), g.GPCSDTemporalCovMatern(model.t)],
        sig2n_prior=[g.HalfNormal(0.1) for _ in range(24)], het_noise="exact",
    )
    jm.temporal_cov_list[0].params["ell"]["prior"] = g.InvGamma.from_interval(30.0, 100.0)
    jm.temporal_cov_list[1].params["ell"]["prior"] = g.InvGamma.from_interval(1.0, 20.0)
    jfns = jm._fns()
    jgrad = jax.jit(jax.vmap(jax.grad(jfns.log_prob), (0, None)))(jnp.asarray(draws), jm._Y())
    for u, want, g_want in zip(draws, logp64, np.asarray(jgrad)):
        v, gr = value_grad(lambda ut: fns.log_prob(ut, Y), u)
        assert abs(v - want) <= 1e-8 * abs(want)
        assert np.linalg.norm(gr - g_want) <= 1e-4 * np.linalg.norm(g_want)
        np.testing.assert_allclose(gr[2:6], g_want[2:6], rtol=1e-6)


def test_map_fit_matches_jax_from_same_start():
    """Serial scipy L-BFGS-B in both packages from the same prior draws:
    the objectives agree to ~1e-13, so the runs end at the same optimum
    within L-BFGS tolerance (NLL rtol 1e-8, u atol 1e-4)."""
    jm = small_jax_model(seed=3, het=True, het_noise="exact")
    tm = port_of(jm)
    jfns, tfns = jm._fns(), tm._fns()
    key = jax.random.PRNGKey(5)
    u0s = np.asarray(j_sample_restarts(jfns.param_set, key, 2))
    jres = j_map_fit(jfns.neg_log_joint, jfns.param_set, jm._Y(), key, n_restarts=2,
                     backend="scipy", maxiter=200)
    tres = t_map_fit(tfns.neg_log_joint, tfns.param_set, tm._Y(), u0s, maxiter=200)
    np.testing.assert_allclose(tres.nll_values, jres.nll_values, rtol=1e-8)
    np.testing.assert_allclose(tres.u_best, jres.u_best, atol=1e-4)


def test_fit_decreases_nll():
    """GPCSD1D.fit: the best restart ends no higher than where it started,
    and the fitted values are written back into the model."""
    tm = port_of(small_jax_model(seed=4))
    fns, Y = tm._fns(), tm._Y()
    res = tm.fit(n_restarts=2, seed=1, options={"maxiter": 15})
    from gpcsd_tpu_torch.infer.map import sample_restarts

    u0s = sample_restarts(fns.param_set, np.random.default_rng(1), 2)
    nll0 = [value_grad(lambda ut: fns.neg_log_joint(ut, Y), u)[0] for u in u0s]
    assert np.isfinite(res.nll_best)
    assert np.all(res.nll_values <= np.asarray(nll0))
    u_model = fns.param_set.pack(tm._theta()).numpy()
    np.testing.assert_allclose(u_model, res.u_best, rtol=1e-12)
