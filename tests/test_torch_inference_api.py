"""PyTorch port, the posterior API: the batched log-joint, the Laplace
Hessian, the diagnostics copy, ``sample_posterior`` and the state
conversion, against the JAX package on CPU float64.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpcsd_tpu as g
import gpcsd_tpu_torch as gt
from gpcsd_tpu.infer import diagnostics as jd
from gpcsd_tpu_torch import convert
from gpcsd_tpu_torch.infer import diagnostics as td
from gpcsd_tpu_torch.infer.advi import ADVIResult
from gpcsd_tpu_torch.infer.nuts import NUTSResult
from gpcsd_tpu_torch.infer.smc import SMCResult
from gpcsd_tpu_torch.models.core import value_and_grad_rows
from torch_port_helpers import jax_small_model, port_of
from gpcsd_tpu_torch.models.inference_api import (
    PosteriorSamples,
    laplace_hessian,
    whitening_from_hessian,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def small_model():
    return port_of(jax_small_model())


# ------------------------------------------------- the batched log-joint


@pytest.mark.parametrize("fix_R", [False, True], ids=["free_R", "fix_R"])
@pytest.mark.parametrize("noise", ["scalar", "per_channel_approx", "per_channel_exact"])
def test_batched_log_joint_rows_equal_unbatched_calls(noise, fix_R):
    """``log_prob``, ``neg_log_joint``, ``log_prior_u`` on (C, dim) give the
    C unbatched values, and one backward of the sum the C unbatched
    gradients, to 1e-12 (the same operations, batched)."""
    jm = jax_small_model("exact" if noise.endswith("exact") else "approx", noise != "scalar")
    tm = port_of(jm)
    fns, Y = tm._fns(fix_R=fix_R), tm._Y()
    u0 = fns.param_set.pack(tm._theta())
    us = u0[None] + 0.1 * torch.tensor(np.random.default_rng(0).normal(size=(5, u0.numel())))
    np.testing.assert_allclose(
        fns.log_prior_u(us).numpy(), [float(fns.log_prior_u(u)) for u in us], rtol=1e-12)
    for name in ("log_prob", "neg_log_joint"):
        fn = getattr(fns, name)
        vals, grads = value_and_grad_rows(lambda u: fn(u, Y), us)
        assert vals.shape == (5,) and grads.shape == us.shape
        assert not vals.requires_grad and not grads.requires_grad
        for u, v, gr in zip(us, vals, grads):
            ui = u.clone().requires_grad_()
            f = fn(ui, Y)
            assert f.ndim == 0
            (gi,) = torch.autograd.grad(f, ui)
            assert np.isclose(float(v), float(f.detach()), rtol=1e-12, atol=0.0)
            np.testing.assert_allclose(gr.numpy(), gi.numpy(), rtol=1e-12,
                                       atol=1e-12 * float(gi.abs().max()))


def test_batched_log_joint_matches_jax_vmap():
    jm = jax_small_model("exact", True)
    tm = port_of(jm)
    jf, tf = jm._fns(), tm._fns()
    u0 = np.asarray(jf.param_set.pack(jm._theta()))
    us = u0[None] + 0.1 * np.random.default_rng(1).normal(size=(4, u0.size))
    want_v, want_g = jax.vmap(jax.value_and_grad(jf.log_prob), (0, None))(jnp.asarray(us), jm._Y())
    got_v, got_g = value_and_grad_rows(lambda u: tf.log_prob(u, tm._Y()), torch.tensor(us))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-11)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-8,
                               atol=1e-8 * float(np.abs(want_g).max()))


def test_non_finite_row_stays_in_its_row():
    """A point whose covariance overflows gives a non-finite density in
    its own row and leaves the other rows' values and gradients as they
    were (a divergent chain must not take the batch down)."""
    tm = port_of(jax_small_model("exact", True))
    fns, Y = tm._fns(), tm._Y()
    u0 = fns.param_set.pack(tm._theta())
    us = torch.stack([u0, u0 + 800.0, u0 - 0.1])
    vals, grads = value_and_grad_rows(lambda u: fns.log_prob(u, Y), us)
    assert not torch.isfinite(vals[1])
    ref_v, ref_g = value_and_grad_rows(lambda u: fns.log_prob(u, Y), us[[0, 2]])
    assert torch.equal(vals[[0, 2]], ref_v) and torch.equal(grads[[0, 2]], ref_g)
    assert torch.isfinite(ref_g).all()


# ------------------------------------------------------------- Hessian


@pytest.mark.parametrize("noise", ["scalar", "per_channel_exact"])
def test_laplace_hessian_matches_jax_hessian(noise):
    """Central differences of the batched gradient (h = 1e-4) against
    ``jax.hessian`` of the JAX ``neg_log_joint``: within 1e-5 of max|H|."""
    jm = jax_small_model("exact" if noise.endswith("exact") else "approx", noise != "scalar")
    tm = port_of(jm)
    jf = jm._fns()
    u0 = jnp.asarray(jf.param_set.pack(jm._theta()))
    want = np.asarray(jax.hessian(lambda u: jf.neg_log_joint(u, jm._Y()))(u0))
    got = laplace_hessian(tm._fns(), np.asarray(u0), tm._Y())
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_array_equal(got, got.T)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_whitening_is_saddle_free():
    rng = np.random.default_rng(2)
    q = np.linalg.qr(rng.normal(size=(4, 4)))[0]
    H = (q * np.array([100.0, -4.0, 1.0, 1e-12])) @ q.T
    A, A_inv = whitening_from_hessian(H)
    np.testing.assert_allclose(A @ A_inv, np.eye(4), atol=1e-9)
    w = np.linalg.eigvalsh(A)  # H^{-1/2} on |w| floored at 1e-6 * 100
    np.testing.assert_allclose(np.sort(w), np.sort(1 / np.sqrt([100.0, 4.0, 1.0, 1e-4])), rtol=1e-8)


# --------------------------------------------------------- diagnostics


def test_diagnostics_copy_matches_jax_package():
    """The port's own copy against the JAX package's module on the same
    arrays (AR(1) chains, a shifted chain, a frozen dimension): 1e-12."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 200, 3))
    for i in range(1, 200):
        x[:, i, 1] = 0.9 * x[:, i - 1, 1] + np.sqrt(1 - 0.81) * x[:, i, 1]
    x[0, :, 2] += 1.5
    frozen = x.copy()
    frozen[1, :, 0] = 0.25
    for s in (x, frozen):
        np.testing.assert_array_equal(td.split_chains(s), jd.split_chains(s))
        for name in ("rhat", "ess_bulk", "ess_tail", "ess"):
            np.testing.assert_allclose(getattr(td, name)(s), getattr(jd, name)(s), rtol=1e-12)
    assert np.isinf(td.rhat(frozen)[0])
    got, want = td.summarize(x, names=["a", "b", "c"]), jd.summarize(x, names=["a", "b", "c"])
    assert got.keys() == want.keys()
    for k in want:
        for stat in want[k]:
            assert np.isclose(got[k][stat], want[k][stat], rtol=1e-12), (k, stat)
    np.testing.assert_allclose(td.ess_bulk(x[0]), jd.ess_bulk(x[0]), rtol=1e-12)  # 2-d input


# ----------------------------------------------------- sample_posterior


def test_sample_posterior_shapes_and_diagnostics(small_model):
    post = small_model.sample_posterior(n_chains=2, num_warmup=30, num_samples=40, seed=0,
                                        max_depth=5)
    assert isinstance(post, PosteriorSamples) and post is small_model.posterior
    assert set(post.theta) == {"R", "ell", "tm0_ell", "tm0_sigma2", "tm1_ell", "tm1_sigma2", "sig2n"}
    for v in post.theta.values():
        assert v.shape == (80,) and np.isfinite(v).all() and (v > 0).all()
    assert isinstance(post.raw, NUTSResult) and post.raw.samples.shape == (2, 40, 7)
    # constrained draws are the exp bijector of the raw draws, inside its range
    np.testing.assert_allclose(post.theta["R"], 100.0 * np.exp(post.raw.samples[..., 0].reshape(-1).numpy()))
    d = post.diagnostics
    assert d["accept_prob"].shape == d["num_steps"].shape == d["diverging"].shape == (2, 40)
    assert d["step_size"].shape == (2,) and np.isfinite(d["accept_prob"]).all()
    assert (d["num_steps"] >= 1).all() and (d["num_steps"] < 2 ** 5).all()
    for key in ("rhat", "ess", "ess_tail"):
        assert list(d[key]) == list(post.theta) and np.isfinite(list(d[key].values())).all()


def test_sample_posterior_per_channel_noise_fix_R():
    tm = port_of(jax_small_model("exact", True))
    post = tm.sample_posterior(n_chains=2, num_warmup=20, num_samples=10, seed=0, max_depth=5,
                               fix_R=True, dense_mass=True, pool_warmup=True)
    assert "R" not in post.theta and post.theta["sig2n"].shape == (20, 6)
    assert post.raw.inv_mass.shape == (2, 11, 11)
    assert list(post.diagnostics["rhat"])[-1] == "sig2n[5]"


def test_init_modes(small_model):
    kw = dict(n_chains=2, num_warmup=20, num_samples=10, seed=0, max_depth=5)
    prior = small_model.sample_posterior(init="prior", **kw)
    jitter = small_model.sample_posterior(init="params_jitter", **kw)
    assert np.isfinite(prior.theta["R"]).all() and np.isfinite(jitter.theta["R"]).all()
    assert not np.array_equal(prior.theta["R"], jitter.theta["R"])
    with pytest.raises(ValueError, match="unknown init"):
        small_model.sample_posterior(n_chains=2, num_warmup=2, num_samples=2, init="nope")


def test_precomputed_hessian(small_model, tmp_path):
    """A (dim, dim) array and an ``.npz`` path with key ``H`` give the same
    whitening and so the same draws as the in-process Hessian."""
    fns = small_model._fns()
    u0 = fns.param_set.pack(small_model._theta()).numpy()
    H = laplace_hessian(fns, u0, small_model._Y())
    kw = dict(n_chains=2, num_warmup=20, num_samples=10, seed=3, max_depth=5)
    own = small_model.sample_posterior(**kw)
    arr = small_model.sample_posterior(laplace_hessian=convert.hessian_from_numpy(H), **kw)
    path = str(tmp_path / "hess.npz")
    np.savez(path, H=H)
    npz = small_model.sample_posterior(laplace_hessian=path, **kw)
    np.testing.assert_array_equal(arr.theta["R"], own.theta["R"])
    np.testing.assert_array_equal(npz.theta["R"], own.theta["R"])
    with pytest.raises(ValueError, match="laplace_hessian"):
        small_model.sample_posterior(n_chains=2, num_warmup=2, num_samples=2,
                                     laplace_hessian=np.eye(8))
    with pytest.raises(ValueError, match="laplace_hessian"):
        convert.hessian_from_numpy(np.zeros((3, 4)))


def test_set_posterior_mean(small_model):
    R_before = small_model.R["value"]
    post = small_model.sample_posterior(n_chains=1, num_warmup=30, num_samples=30, seed=1,
                                        max_depth=5, set_posterior_mean=True)
    assert "rhat" not in post.diagnostics  # one chain
    assert small_model.R["value"] != R_before
    assert np.isclose(np.log(small_model.R["value"] / 100.0), post.raw.samples[0, :, 0].mean())
    assert np.isfinite(small_model.loglik())


def test_unknown_keywords_raise(small_model):
    """Arguments of the JAX ``sample_posterior`` that the port does not
    take are absent, not accepted and ignored (``mesh`` it takes, as
    ``advi`` and ``smc`` do: ``tests/test_torch_parallel.py``)."""
    for kw in ({"chunk_size": 10}, {"warm_basis": True}, {"precondition": True}):
        with pytest.raises(TypeError):
            small_model.sample_posterior(n_chains=1, num_warmup=1, num_samples=1, **kw)


# ------------------------------------- advi, smc, information_criteria


def _same_layout(got, want):
    """Same names and shapes in ``theta`` and ``diagnostics``."""
    assert set(got.theta) == set(want.theta)  # jax.vmap returns the dict sorted
    for k in want.theta:
        assert got.theta[k].shape == np.asarray(want.theta[k]).shape, k
        assert np.isfinite(got.theta[k]).all() and (got.theta[k] > 0).all()
    assert got.diagnostics.keys() == want.diagnostics.keys()
    for k in want.diagnostics:
        assert np.shape(got.diagnostics[k]) == np.shape(want.diagnostics[k]), k


def test_advi_returns_the_jax_layout():
    jm = jax_small_model("exact", True)
    tm = port_of(jm)
    kw = dict(num_steps=40, n_mc=4, n_draws=50, seed=1)
    got, want = tm.advi(**kw), jm.advi(**kw)
    assert got is tm.posterior and isinstance(got.raw, ADVIResult)
    _same_layout(got, want)
    assert got.theta["sig2n"].shape == (50, 6) and got.diagnostics["elbo"].shape == (40,)
    assert got.raw.mu.shape == (12,) and np.isfinite(got.diagnostics["elbo"]).any()
    # the seed decides the draws
    np.testing.assert_array_equal(tm.advi(**kw).theta["R"], got.theta["R"])
    assert not np.array_equal(tm.advi(**{**kw, "seed": 2}).theta["R"], got.theta["R"])
    assert "R" not in tm.advi(fix_R=True, **kw).theta


def test_smc_returns_the_jax_layout():
    jm = jax_small_model()
    tm = port_of(jm)
    kw = dict(n_particles=48, n_mutation_steps=2, seed=0)
    got, want = tm.smc(batch=20, **kw), jm.smc(**kw)
    assert got is tm.posterior and isinstance(got.raw, SMCResult)
    _same_layout(got, want)
    assert got.theta["R"].shape == (48,) and got.raw.particles.shape == (48, 7)
    assert np.isfinite(got.diagnostics["log_evidence"]) and got.diagnostics["n_stages"] >= 1
    assert 0.0 <= float(got.diagnostics["acceptance"]) <= 1.0
    assert float(got.raw.temperatures[-1]) == 1.0
    # the two packages temper the same posterior from their own prior draws:
    # evidence within a few log-units at 48 particles
    assert abs(float(got.diagnostics["log_evidence"]) - float(want.diagnostics["log_evidence"])) < 10.0


@pytest.mark.parametrize("engine", ["nuts", "advi"])
def test_information_criteria_returns_the_jax_layout(engine):
    """WAIC and PSIS-LOO over either engine's stored posterior: the JAX
    dict's keys and shapes, and on the SAME posterior draws the same numbers
    to 1e-8 (the draws are handed to the JAX model as its posterior)."""
    jm = jax_small_model("exact", True)
    tm = port_of(jm)
    if engine == "nuts":
        tm.sample_posterior(n_chains=2, num_warmup=20, num_samples=30, seed=0, max_depth=4)
    else:
        tm.advi(num_steps=40, n_mc=4, n_draws=60, seed=0)
    jm.posterior = tm.posterior
    got, want = tm.information_criteria(max_draws=40, batch=16), jm.information_criteria(max_draws=40)
    assert got.keys() == want.keys() == {"n_draws", "waic", "loo"} and got["n_draws"] == 40
    for name in ("waic", "loo"):
        assert got[name].keys() == want[name].keys()
        for k, v in want[name].items():
            assert np.shape(got[name][k]) == np.shape(v)
            np.testing.assert_allclose(got[name][k], v, rtol=1e-8, atol=1e-8, err_msg=k)
    assert got["loo"]["pareto_k"].shape == (4,)
    assert tm.information_criteria(method="waic").keys() == {"n_draws", "waic"}
    assert tm.information_criteria(method="loo", max_draws=1000)["n_draws"] == 60


def test_information_criteria_without_posterior_raises(small_model):
    with pytest.raises(RuntimeError, match="no posterior stored"):
        small_model.information_criteria()


def test_pack_batch_inverts_constrain_batch(small_model):
    fns = small_model._fns()
    us = np.random.default_rng(0).normal(size=(5, 7))
    np.testing.assert_allclose(
        small_model._pack_batch(fns, small_model._constrain_batch(fns, us)), us, atol=1e-13)


# ---------------------------------------------------------- state across


def test_nuts_result_from_numpy():
    """A JAX NUTSResult's fields and the banked paper posterior both become
    the port's NUTSResult."""
    jm = jax_small_model()
    jres = jm.sample_posterior(n_chains=2, num_warmup=10, num_samples=6, max_depth=4).raw
    fields = {k: np.asarray(v) for k, v in jres._asdict().items()}
    res = convert.nuts_result_from_numpy(fields, device="cpu")
    assert isinstance(res, NUTSResult)
    for k, v in fields.items():
        np.testing.assert_array_equal(getattr(res, k).numpy(), v)
    assert res.samples.dtype == torch.float64 and res.num_steps.dtype == torch.int64
    with np.load(os.path.join(ROOT, "results", "paper_nuts_hetx", "posterior_samples.npz")) as d:
        banked = convert.nuts_result_from_numpy(d, device="cpu")
        np.testing.assert_array_equal(banked.samples.numpy(), d["raw_u"])
    assert banked.samples.shape == (4, 500, 30) and banked.step_size.shape == (4,)
    assert banked.accept_prob is None and banked.inv_mass is None
    with pytest.raises(KeyError, match="samples"):
        convert.nuts_result_from_numpy({"logp": np.zeros(3)}, device="cpu")
