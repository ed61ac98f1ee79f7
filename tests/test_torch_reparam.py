"""PyTorch port, ``models/reparam.py``: the amplitude reparameterization
against the JAX class on the same points (CPU float64), its unimodular
Jacobian by autograd, and ``sample_posterior(reparam="amplitude")``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcsd_tpu.models.reparam import AmplitudeReparam as JaxReparam
from gpcsd_tpu_torch.models.reparam import AmplitudeReparam
from torch_port_helpers import jax_small_model, port_of

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    jm = jax_small_model("exact", True)
    return jm, port_of(jm)


def _points(jm, n, seed=0, scale=0.3):
    u0 = np.asarray(jm._fns().param_set.pack(jm._theta()))
    return u0[None] + scale * np.random.default_rng(seed).normal(size=(n, u0.size))


def test_forward_inverse_match_jax(pair):
    """Both maps against the JAX class to 1e-10, one vector at a time and as
    (C, dim) rows in one call; the rows equal the single calls bit for bit
    up to 1e-13 (the same operations, batched)."""
    jm, tm = pair
    jrp, trp = JaxReparam(jm._fns()), AmplitudeReparam(tm._fns())
    us = _points(jm, 5)
    fwd_rows = trp.forward(torch.tensor(us))
    inv_rows = trp.inverse(torch.tensor(us))
    assert fwd_rows.shape == inv_rows.shape == us.shape
    for i, u in enumerate(us):
        want_f, want_i = np.asarray(jrp.forward(jnp.asarray(u))), np.asarray(jrp.inverse(jnp.asarray(u)))
        got_f, got_i = trp.forward(torch.tensor(u)), trp.inverse(torch.tensor(u))
        assert got_f.shape == (us.shape[1],)
        np.testing.assert_allclose(got_f.numpy(), want_f, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got_i.numpy(), want_i, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(fwd_rows[i].numpy(), got_f.numpy(), rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(inv_rows[i].numpy(), got_i.numpy(), rtol=1e-13, atol=1e-13)
    # only the sigma2 slots move
    moved = np.flatnonzero(np.abs(fwd_rows.numpy() - us).max(axis=0) > 0)
    assert moved.tolist() == trp._s_offsets == jrp._s_offsets


def test_round_trip_and_semantics(pair):
    """``inverse(forward(u)) = u`` to 1e-12, and ``exp(v_P)`` is the mean
    per-channel signal variance ``tr(Ks) / nx * sum(sigma2)``."""
    jm, tm = pair
    fns = tm._fns()
    trp = AmplitudeReparam(fns)
    us = torch.tensor(_points(jm, 6, seed=1))
    v = trp.forward(us)
    np.testing.assert_allclose(trp.inverse(v).numpy(), us.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(trp.forward(trp.inverse(us)).numpy(), us.numpy(), rtol=0, atol=1e-12)
    theta = fns.param_set.unpack(us[0])
    power = torch.trace(fns.build_ks(theta)) / 6 * (theta["tm0_sigma2"] + theta["tm1_sigma2"])
    assert np.isclose(float(torch.exp(v[0, trp._s_offsets[0]])), float(power), rtol=1e-12)


def test_jacobian_is_unimodular(pair):
    """|det dT/du| = 1 by autograd (both maps), to 1e-10; so the wrapped
    density needs no correction and equals ``log_prob`` at the same point."""
    jm, tm = pair
    fns, Y = tm._fns(), tm._Y()
    trp = AmplitudeReparam(fns)
    for u in torch.tensor(_points(jm, 3, seed=2)):
        J = torch.autograd.functional.jacobian(trp.forward, u)
        Ji = torch.autograd.functional.jacobian(trp.inverse, trp.forward(u))
        assert abs(float(torch.linalg.det(J)) - 1.0) < 1e-10
        assert abs(float(torch.linalg.det(Ji)) - 1.0) < 1e-10
        np.testing.assert_allclose((J @ Ji).numpy(), np.eye(u.numel()), atol=1e-9)
    us = torch.tensor(_points(jm, 4, seed=3))
    lp_v = trp.wrap_log_prob(fns.log_prob)(trp.forward(us), Y)
    np.testing.assert_allclose(lp_v.numpy(), fns.log_prob(us, Y).numpy(), rtol=1e-12)
    # autograd follows the out-of-place assembly through the wrapped density
    v = trp.forward(us).requires_grad_()
    (g,) = torch.autograd.grad(trp.wrap_log_prob(fns.log_prob)(v, Y).sum(), v)
    assert g.shape == us.shape and torch.isfinite(g).all()


def test_fix_R_and_no_sigma2():
    """With R fixed the gain uses the fixed value; a parameter set without
    temporal sigma2's is refused."""
    tm = port_of(jax_small_model())
    fns = tm._fns(fix_R=True)
    trp = AmplitudeReparam(fns)
    u = fns.param_set.pack({k: v for k, v in tm._theta().items() if k != "R"})
    np.testing.assert_allclose(trp.inverse(trp.forward(u)).numpy(), u.numpy(), atol=1e-12)

    class NoSigma2:
        param_set = type("PS", (), {"specs": {}, "dim": 0, "_offsets": {}})()

    with pytest.raises(ValueError, match="no temporal sigma2"):
        AmplitudeReparam(NoSigma2())


def test_sample_posterior_reparam_moments():
    """``reparam="amplitude"`` samples the same posterior: per parameter the
    means in log units agree with the plain run's within Monte-Carlo error
    (the JAX test's tolerance, 0.6 sd + 0.15; 2 x (40 + 60) each), the
    draws are finite and come back in u."""
    tm = port_of(jax_small_model())
    kw = dict(n_chains=2, num_warmup=40, num_samples=60, max_depth=4)
    plain = tm.sample_posterior(seed=5, **kw)
    rep = tm.sample_posterior(seed=6, reparam="amplitude", **kw)
    assert rep.raw.samples.shape == (2, 60, 7)
    assert rep.diagnostics["diverging"].mean() < 0.05
    for name in ("R", "ell", "tm0_ell", "tm0_sigma2", "tm1_sigma2", "sig2n"):
        a, b = np.log(rep.theta[name]), np.log(plain.theta[name])
        assert np.isfinite(a).all()
        tol = 0.6 * max(a.std(), b.std()) + 0.15
        assert abs(a.mean() - b.mean()) < tol, (name, a.mean(), b.mean())
    # without whitening the nonlinear map alone carries the draws back
    short = tm.sample_posterior(n_chains=2, num_warmup=10, num_samples=6, max_depth=4,
                                reparam="amplitude", laplace=False)
    np.testing.assert_allclose(short.theta["R"],
                               100.0 * np.exp(short.raw.samples[..., 0].reshape(-1).numpy()))


def test_unknown_reparam_raises():
    tm = port_of(jax_small_model())
    with pytest.raises(ValueError, match="unknown reparam"):
        tm.sample_posterior(n_chains=1, num_warmup=1, num_samples=1, reparam="nope")
