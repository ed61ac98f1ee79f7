"""PyTorch port, prediction: ``kron_cross_mean``, ``posterior_predict``,
``GPCSD1D.predict`` / ``update_lfp`` / ``sample_prior`` against the JAX
package on CPU float64 with parameters carried across by ``convert``, and
the simulate -> fit -> predict round trip on the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpcsd_tpu as g
import gpcsd_tpu_torch as gt
from gpcsd_tpu.models.core import posterior_predict as j_posterior_predict
from gpcsd_tpu.ops import kronlik as jk
from gpcsd_tpu_torch import convert
from gpcsd_tpu_torch.models.core import posterior_predict as t_posterior_predict
from gpcsd_tpu_torch.ops import kronlik as tk
from gpcsd_tpu_torch.ops.forward import fwd_model_1d

torch.set_num_threads(2)

def assert_close(got, want):
    """Relative error 5e-9 in the max norm.  Both packages run the same
    float64 factorization, and the solve amplifies the two eigensolvers'
    last-bit differences by the covariance's conditioning: at this size
    the packages differ by 3e-11 to 5e-10 on the totals and up to 1.5e-9
    on single temporal components (whose split is the least determined),
    and each sits 4e-10 to 1.1e-9 from a dense numpy solve.  So 1e-9 is
    the noise floor of the comparison, not a bound it can hold; an
    elementwise rtol cannot hold near zero crossings either."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 5e-9 * np.max(np.abs(want))


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def jax_model(het_noise="approx", nx=8, nt=40, ntrials=3, seed=0):
    rng = np.random.default_rng(seed)
    x = (np.arange(nx) * 100.0).reshape(-1, 1)
    t = np.arange(nt).reshape(-1, 1) * 1.0
    het = het_noise == "exact"
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


def port_of(jm):
    prior = jm.sig2n["prior"]
    prior = [gt.HalfNormal(p.sd) for p in prior] if isinstance(prior, list) else gt.HalfNormal(prior.sd)
    return convert.model_from_reference_params(
        jm.lfp, jm.x, jm.t, {k: np.asarray(v) for k, v in jm._theta().items()},
        a=jm.a, b=jm.b, ngl=jm.ngl, sig2n_prior=prior, het_noise=jm.het_noise, device="cpu",
    )


def test_kron_cross_mean_matches_jax():
    rng = np.random.default_rng(1)
    Kxz, Ktt, V = rng.normal(size=(8, 5)), rng.normal(size=(40, 7)), rng.normal(size=(3, 8, 40))
    want = np.asarray(jk.kron_cross_mean(jnp.asarray(Kxz), jnp.asarray(Ktt), jnp.asarray(V)))
    got = tk.kron_cross_mean(T(Kxz), T(Ktt), T(V))
    assert got.shape == (3, 5, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    dense = np.stack([np.kron(Kxz, Ktt).T @ v.reshape(-1) for v in V]).reshape(3, 5, 7)
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("het_noise", ["approx", "exact"])
def test_posterior_predict_matches_jax(het_noise):
    jm = jax_model(het_noise)
    tm = port_of(jm)
    z = np.linspace(50.0, 650.0, 11).reshape(-1, 1)
    tstar = np.linspace(0.0, 39.0, 17)
    jth, tth = jm._theta(), tm._theta()
    jout = j_posterior_predict(
        jm._fns(), jth, jm._Y(), kphig=jm.spatial_cov.compKphig_1d(z, jth["R"]),
        kphi=jm.spatial_cov.compKphi_1d(jth["R"], xp=z), t_data=jm.t.reshape(-1), t_star=tstar)
    tout = t_posterior_predict(
        tm._fns(), tth, tm._Y(), kphig=tm.spatial_cov.compKphig_1d(z, tth["R"], device="cpu"),
        kphi=tm.spatial_cov.compKphi_1d(tth["R"], xp=z, device="cpu"),
        t_data=T(tm.t.reshape(-1)), t_star=T(tstar))
    assert set(tout) == {"csd", "lfp"}
    for name in ("csd", "lfp"):
        assert tout[name][0].shape == (3, 11, 17)
        assert_close(tout[name][0].numpy(), np.asarray(jout[name][0]))
        for a, b in zip(tout[name][1], jout[name][1]):
            assert_close(a.numpy(), np.asarray(b))
    only_csd = t_posterior_predict(
        tm._fns(), tth, tm._Y(), kphig=tm.spatial_cov.compKphig_1d(z, tth["R"], device="cpu"),
        t_data=T(tm.t.reshape(-1)), t_star=T(tstar))
    assert set(only_csd) == {"csd"}


@pytest.mark.parametrize("het_noise", ["approx", "exact"])
@pytest.mark.parametrize("kind", ["csd", "lfp", "both"])
def test_predict_matches_jax(kind, het_noise):
    """All three ``type``s: the returned total, the stored totals and
    per-component lists, in the reference's (nz, ntstar, ntrials) layout."""
    jm = jax_model(het_noise)
    tm = port_of(jm)
    z = np.linspace(0.0, 700.0, 15)
    tstar = np.arange(5.0, 35.0, 2.0)
    jret, tret = jm.predict(z, tstar, type=kind), tm.predict(z, tstar, type=kind)
    assert tret.shape == (15, 15, 3) and isinstance(tret, np.ndarray)
    assert_close(tret, jret)
    for name in ("csd", "lfp"):
        if kind in (name, "both"):
            assert_close(getattr(tm, f"{name}_pred"), getattr(jm, f"{name}_pred"))
            tl, jl = getattr(tm, f"{name}_pred_list"), getattr(jm, f"{name}_pred_list")
            assert len(tl) == len(jl) == 2
            for a, b in zip(tl, jl):
                assert_close(a, b)
            np.testing.assert_allclose(tl[0] + tl[1], getattr(tm, f"{name}_pred"), rtol=1e-12, atol=1e-12)
        else:
            assert not hasattr(tm, f"{name}_pred")
    np.testing.assert_array_equal(tm.t_pred, jm.t_pred)
    np.testing.assert_array_equal(tm.x_pred, jm.x_pred)
    with pytest.raises(ValueError, match="type"):
        tm.predict(z, tstar, type="variance")


def test_update_lfp_then_predict_matches_jax():
    """New data on a shorter time grid and moved electrodes: the cached
    functions are dropped and the prediction follows the new data."""
    jm = jax_model("exact")
    tm = port_of(jm)
    before = tm.predict(tm.x, tm.t)
    rng = np.random.default_rng(5)
    new_lfp, new_t = rng.normal(size=(8, 25)), np.arange(25.0) * 2.0
    new_x = (np.arange(8) * 90.0 + 10.0).reshape(-1, 1)
    for m in (jm, tm):
        m.update_lfp(new_lfp, new_t, x=new_x)
    assert tm.lfp.shape == (8, 25, 1) and tm._Y().shape == (1, 8, 25)
    np.testing.assert_array_equal(tm.temporal_cov_list[1].t, jm.temporal_cov_list[1].t)
    got, want = tm.predict(new_x, new_t), jm.predict(new_x, new_t)
    assert got.shape == (8, 25, 1) != before.shape
    assert_close(got, want)
    assert np.isclose(tm.loglik(), jm.loglik(), rtol=1e-10)


def test_sample_prior_covariance():
    """2000 prior draws at nx=3, nt=4: the sample covariance of vec(csd)
    is ``Ks_csd (x) Kt`` within 5 standard errors of its entries
    (se ~ sqrt((k_ii k_jj + k_ij^2) / n)), and the draw follows ``seed``."""
    x = (np.arange(3) * 100.0).reshape(-1, 1)
    t = np.arange(4.0).reshape(-1, 1)
    m = gt.GPCSD1D(np.zeros((3, 4, 1)), x, t, ngl=10, device="cpu")
    m.spatial_cov.params["ell"]["value"] = 120.0
    m.temporal_cov_list[0].params["ell"]["value"] = 2.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 0.7
    m.temporal_cov_list[1].params["ell"]["value"] = 1.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.3
    n = 2000
    csd = m.sample_prior(n, seed=3)
    assert csd.shape == (3, 4, n)
    np.testing.assert_array_equal(csd, m.sample_prior(n, seed=3))
    assert not np.array_equal(csd[..., :5], m.sample_prior(5, seed=4))
    Ks = m.spatial_cov.compute_Ks(device="cpu").numpy() + 1e-8 * np.eye(3)
    Kt = sum(tc.compute_Kt(device="cpu").numpy() for tc in m.temporal_cov_list)
    K = np.kron(Ks, Kt)
    emp = np.cov(csd.reshape(12, n))
    se = np.sqrt((np.outer(np.diag(K), np.diag(K)) + K ** 2) / n)
    assert np.all(np.abs(emp - K) < 5 * se)


def test_round_trip_recovers_csd():
    """Simulate CSD from a generator model, push it through the forward
    model, add noise, fit a fresh model and predict the CSD at the
    electrodes: correlation with the truth above 0.95."""
    nx, nt, ntrials = 16, 30, 10
    x = (np.arange(nx) * 100.0).reshape(-1, 1)
    t = np.arange(nt * 1.0).reshape(-1, 1)
    gen = gt.GPCSD1D(np.zeros((nx, nt, 1)), x, t, device="cpu")
    gen.R["value"] = 150.0
    gen.spatial_cov.params["ell"]["value"] = 250.0
    gen.temporal_cov_list[0].params["ell"]["value"] = 8.0
    gen.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    gen.temporal_cov_list[1].params["ell"]["value"] = 3.0
    gen.temporal_cov_list[1].params["sigma2"]["value"] = 0.3
    csd = gen.sample_prior(ntrials, seed=7)
    lfp = np.moveaxis(fwd_model_1d(np.moveaxis(csd, 2, 0), x.ravel(), x.ravel(), 150.0).numpy(), 0, 2)
    lfp = lfp / np.max(np.abs(lfp))
    lfp = lfp + 0.01 * np.random.default_rng(0).normal(size=lfp.shape)
    m = gt.GPCSD1D(lfp, x, t, device="cpu")
    m.fit(n_restarts=3, seed=0)
    pred = m.predict(x, t)
    assert pred.shape == csd.shape
    assert np.corrcoef(pred.ravel(), csd.ravel())[0, 1] > 0.95
