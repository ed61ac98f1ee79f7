"""PyTorch port, ``infer/advi.py`` and ``infer/smc.py``: against the JAX
engines on the same pre-drawn random numbers (CPU float64; ``jax.random``
is fed the port's draws, for SMC from a queue under ``jax.disable_jit()``),
and on targets with closed-form answers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcsd_tpu.infer import advi as ja
from gpcsd_tpu.infer import smc as js
from gpcsd_tpu_torch import convert
from gpcsd_tpu_torch.infer import advi as ta
from gpcsd_tpu_torch.infer import smc as ts
from torch_port_helpers import RandomFeed, jax_small_model, port_of

torch.set_num_threads(2)


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _jax_advi(lp, u0, eps, **kw):
    """The JAX ``advi_fit`` on the draws ``eps`` (steps, n_mc, dim): its
    per-step keys are replaced by step indices and its normal draw by a
    look-up of that step's rows, so the jitted ``lax.scan`` consumes the
    port's numbers in the port's order."""
    table = jnp.asarray(eps)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "split", lambda key, n: jnp.arange(n))
        mp.setattr(jax.random, "normal", lambda k, shape, dtype: table[k])
        return jax.jit(lambda u: ja.advi_fit(lp, u, None, num_steps=len(eps),
                                             n_mc=eps.shape[1], **kw))(jnp.asarray(u0))


# ------------------------------------------------------------------ ADVI


def test_advi_matches_jax_on_gaussian():
    """mu, rho and the ELBO trace after 50 steps to 1e-8: optax's Adam and
    the port's are the same arithmetic on the same draws."""
    mu_t, sd_t = np.array([1.0, -2.0, 0.5]), np.array([0.5, 2.0, 1.0])
    eps = ta.draw_eps(torch.Generator().manual_seed(0), 50, 8, 3).numpy()
    want = _jax_advi(lambda u: -0.5 * jnp.sum(((u - mu_t) / sd_t) ** 2), np.zeros(3), eps,
                     learning_rate=0.05)
    got = ta.advi_fit(lambda u: -0.5 * torch.sum(((u - T(mu_t)) / T(sd_t)) ** 2, dim=-1),
                      torch.zeros(3, dtype=torch.float64), eps=eps, num_steps=50, learning_rate=0.05)
    for name in ("mu", "rho", "elbo_trace"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-8, atol=1e-8, err_msg=name)
    # the same numbers from a generator as from the pre-drawn array
    again = ta.advi_fit(lambda u: -0.5 * torch.sum(((u - T(mu_t)) / T(sd_t)) ** 2, dim=-1),
                        torch.zeros(3, dtype=torch.float64), torch.Generator().manual_seed(0),
                        num_steps=50, learning_rate=0.05)
    assert torch.equal(again.mu, got.mu) and torch.equal(again.elbo_trace, got.elbo_trace)
    # ... and a JAX result crosses into the port's type
    res = convert.advi_result_from_numpy({k: np.asarray(v) for k, v in want._asdict().items()},
                                         device="cpu")
    assert isinstance(res, ta.ADVIResult) and res.mu.dtype == torch.float64
    np.testing.assert_array_equal(res.rho.numpy(), np.asarray(want.rho))
    assert res.sample(torch.Generator().manual_seed(1), 64).shape == (64, 3)


def test_advi_matches_jax_on_gpcsd1d():
    """20 steps on a small GPCSD1D ``log_prob`` (per-channel noise, exact)
    to 1e-6: one batched call of 4 rows against ``jax.vmap``."""
    jm = jax_small_model("exact", True)
    tm = port_of(jm)
    jf, tf, jY, tY = jm._fns(), tm._fns(), jm._Y(), tm._Y()
    u0 = np.asarray(jf.param_set.pack(jm._theta()))
    eps = ta.draw_eps(torch.Generator().manual_seed(1), 20, 4, u0.size).numpy()
    want = _jax_advi(lambda u: jf.log_prob(u, jY), u0, eps)
    got = ta.advi_fit(lambda u: tf.log_prob(u, tY), T(u0), eps=eps, num_steps=20, n_mc=4)
    assert np.isfinite(got.elbo_trace.numpy()).all()
    for name in ("mu", "rho", "elbo_trace"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_advi_skips_non_finite_steps_like_jax():
    """A density that is NaN beyond u_0 = 1.5: steps whose draws cross it
    have a NaN ELBO; both packages feed Adam zeros there (the moments decay,
    the parameters still move) and agree to 1e-8 after 30 steps."""
    eps = ta.draw_eps(torch.Generator().manual_seed(2), 30, 8, 2).numpy()
    u0 = np.array([1.0, 0.0])
    want = _jax_advi(lambda u: -0.5 * jnp.sum(u ** 2) + jnp.log(1.5 - u[0]), u0, eps,
                     init_rho=-1.0, learning_rate=0.05)
    got = ta.advi_fit(lambda u: -0.5 * torch.sum(u ** 2, dim=-1) + torch.log(1.5 - u[..., 0]),
                      T(u0), eps=eps, num_steps=30, init_rho=-1.0, learning_rate=0.05)
    bad = np.isnan(got.elbo_trace.numpy())
    assert 0 < bad.sum() < 30
    np.testing.assert_array_equal(bad, np.isnan(np.asarray(want.elbo_trace)))
    assert torch.isfinite(got.mu).all() and torch.isfinite(got.rho).all()
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(want.rho), rtol=1e-8, atol=1e-8)
    # a skipped step still moves the parameters by the momentum
    first_good = int(np.flatnonzero(~bad)[0])
    k = first_good + 1 + int(np.flatnonzero(bad[first_good + 1:])[0])
    before = ta.advi_fit(lambda u: -0.5 * torch.sum(u ** 2, dim=-1) + torch.log(1.5 - u[..., 0]),
                         T(u0), eps=eps[:k], num_steps=k, init_rho=-1.0, learning_rate=0.05)
    after = ta.advi_fit(lambda u: -0.5 * torch.sum(u ** 2, dim=-1) + torch.log(1.5 - u[..., 0]),
                        T(u0), eps=eps[:k + 1], num_steps=k + 1, init_rho=-1.0, learning_rate=0.05)
    assert not torch.equal(before.mu, after.mu)
    with pytest.raises(ValueError, match="eps has shape"):
        ta.advi_fit(lambda u: u.sum(-1), T(u0), eps=eps, num_steps=7)


def test_advi_gaussian_recovery():
    """The JAX package's recovery test on the port: 3000 steps at a learning
    rate of 0.01 (the last iterate's noise scales with it); means within 0.1
    of a unit-or-wider sd, sds within 20%, and the ELBO rises."""
    mu_t, sd_t = T([1.0, -2.0, 0.5]), T([0.5, 2.0, 1.0])
    res = ta.advi_fit(lambda u: -0.5 * torch.sum(((u - mu_t) / sd_t) ** 2, dim=-1),
                      torch.zeros(3, dtype=torch.float64), torch.Generator().manual_seed(0),
                      num_steps=3000, learning_rate=0.01)
    assert np.all(np.abs(res.mu.numpy() - mu_t.numpy()) < 0.1 * np.maximum(sd_t.numpy(), 1.0))
    assert np.allclose(np.exp(res.rho.numpy()), sd_t.numpy(), rtol=0.2)
    trace = res.elbo_trace.numpy()
    assert np.nanmean(trace[-100:]) > np.nanmean(trace[:100])


# ------------------------------------------------------------------- SMC


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_systematic_resample_and_choose_delta_match_jax(seed):
    """Exact indices on the same uniform; delta to 1e-12, from lam = 0 (where
    the bisection binds) and lam = 0.9 (where the full step may pass)."""
    rng = np.random.default_rng(seed)
    log_w = rng.normal(size=50) * 3.0
    u = rng.uniform()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", RandomFeed([u]))
        want = np.asarray(js.systematic_resample(None, jnp.asarray(log_w), 50))
    got = ts.systematic_resample(T(u), T(log_w), 50)
    np.testing.assert_array_equal(got.numpy(), want)
    log_like = rng.normal(size=200) * 40.0 - 100.0
    for lam, frac in ((0.0, 0.5), (0.9, 0.5), (0.999, 0.05)):
        got = ts._choose_delta(T(log_like), T(lam), frac)
        want = js._choose_delta(jnp.asarray(log_like), jnp.asarray(lam), frac)
        assert float(got) == pytest.approx(float(want), rel=1e-12)
    assert float(ts._choose_delta(T(log_like), T(0.999), 0.05)) == pytest.approx(0.001, rel=1e-9)


def test_systematic_resample_clamps_past_the_end():
    """When roundoff leaves the last cumulative weight short of the last
    position, ``searchsorted`` answers n: JAX's gather clamps that silently,
    torch indexing would raise, so the port clamps to n - 1."""
    n = 1000
    for seed in range(200):
        log_w = T(np.random.default_rng(seed).normal(size=n) * 2.0)
        cum = torch.cumsum(torch.softmax(log_w, dim=-1), dim=0)
        if float(cum[-1]) < 1.0:
            break
    else:
        pytest.fail("no weights whose cumulative sum falls short of 1")
    u = T(1.0)  # the closed end of [0, 1): the last position is exactly 1
    raw = torch.searchsorted(cum, (u + torch.arange(n, dtype=torch.float64)) / n)
    assert int(raw[-1]) == n
    idx = ts.systematic_resample(u, log_w, n)
    assert int(idx.max()) == n - 1 and int(idx.min()) >= 0
    assert torch.isfinite(log_w[idx]).all()  # indexable


def _gauss_problem(dim=2, y=1.0, sd_l=0.5):
    c_p = -0.5 * dim * np.log(2 * np.pi)
    c_l = -dim * np.log(sd_l * np.sqrt(2 * np.pi))
    jp = lambda u: -0.5 * jnp.sum(u ** 2) + c_p  # noqa: E731
    jl = lambda u: -0.5 * jnp.sum((u - y) ** 2) / sd_l ** 2 + c_l  # noqa: E731
    tp = lambda u: -0.5 * torch.sum(u ** 2, dim=-1) + c_p  # noqa: E731
    tl = lambda u: -0.5 * torch.sum((u - y) ** 2, dim=-1) / sd_l ** 2 + c_l  # noqa: E731
    return jp, jl, tp, tl


def test_smc_run_matches_jax_on_same_numbers():
    """64 particles, 3 mutation steps: the same stages, particles to 1e-9,
    evidence to 1e-9, on a queue of the port's own draws; with a likelihood
    that is not finite on part of the space (both count it as -1e300)."""
    jp, jl, tp, tl = _gauss_problem()
    jl_cut = lambda u: jnp.where(u[0] > 2.5, jnp.nan, jl(u))  # noqa: E731
    tl_cut = lambda u: torch.where(u[..., 0] > 2.5, torch.nan, tl(u))  # noqa: E731
    n, dim, n_mut = 64, 2, 3
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(n, dim, generator=gen, dtype=torch.float64)
    noise = [ts.draw_stage_noise(gen, n, dim, n_mut) for _ in range(12)]
    got = ts.smc_run(tp, tl_cut, p0, noise=noise, n_mutation_steps=n_mut, chunk=10)
    assert 2 <= got.n_stages < 12
    normals = [xi for sn in noise for xi in sn.xi]
    uniforms = [a for sn in noise for a in [sn.u_resample, *sn.u_accept]]
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jax.random, "normal", RandomFeed(normals))
        mp.setattr(jax.random, "uniform", RandomFeed(uniforms))
        want = js.smc_run(jp, jl_cut, jnp.asarray(p0.numpy()), jax.random.PRNGKey(0),
                          n_mutation_steps=n_mut)
    assert got.n_stages == int(want.n_stages)
    np.testing.assert_allclose(got.particles.numpy(), np.asarray(want.particles), rtol=1e-9, atol=1e-9)
    assert float(got.log_evidence) == pytest.approx(float(want.log_evidence), rel=1e-9)
    assert float(got.acceptance) == pytest.approx(float(want.acceptance), rel=1e-6)
    assert got.n_host_reads == got.n_stages and got.temperatures.shape == (got.n_stages,)
    assert float(got.temperatures[-1]) == 1.0 and (np.diff(got.temperatures.numpy()) > 0).all()
    assert float(got.log_evidence_increments.sum()) == pytest.approx(float(got.log_evidence))
    # chunked evaluation changes nothing
    whole = ts.smc_run(tp, tl_cut, p0, noise=noise, n_mutation_steps=n_mut)
    assert torch.equal(whole.particles, got.particles)
    res = convert.smc_result_from_numpy({k: np.asarray(v) for k, v in want._asdict().items()},
                                        device="cpu")
    assert isinstance(res, ts.SMCResult) and res.n_stages == got.n_stages
    np.testing.assert_array_equal(res.particles.numpy(), np.asarray(want.particles))


def test_smc_gaussian_posterior_and_evidence():
    """Prior N(0, 1), likelihood N(u; 1, 0.5) per dimension: posterior
    N(0.8, 0.2), evidence in closed form (the JAX test's tolerances)."""
    _, _, tp, tl = _gauss_problem()
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(2000, 2, generator=gen, dtype=torch.float64)
    res = ts.smc_run(tp, tl, p0, gen, n_mutation_steps=10)
    p = res.particles.numpy()
    assert np.allclose(p.mean(0), 0.8, atol=0.05)
    assert np.allclose(p.var(0), 0.2, rtol=0.25)
    want_log_z = 2 * (-0.5 * np.log(2 * np.pi * 1.25) - 0.5 / 1.25)
    assert np.allclose(float(res.log_evidence), want_log_z, atol=0.1)
    assert res.n_stages >= 2 and float(res.acceptance) > 0.1
    assert torch.equal(res.log_weights, torch.zeros(2000, dtype=torch.float64))


def test_smc_multimodal_does_not_collapse():
    """Two well-separated modes: tempering keeps both populated."""
    tp = lambda u: -0.5 * torch.sum((u / 10.0) ** 2, dim=-1)  # noqa: E731
    tl = lambda u: torch.logaddexp(-0.5 * torch.sum((u - 4.0) ** 2, dim=-1) / 0.25,  # noqa: E731
                                   -0.5 * torch.sum((u + 4.0) ** 2, dim=-1) / 0.25)
    gen = torch.Generator().manual_seed(3)
    p0 = 10.0 * torch.randn(1000, 1, generator=gen, dtype=torch.float64)
    res = ts.smc_run(tp, tl, p0, gen)
    assert 0.2 < float((res.particles > 0).double().mean()) < 0.8


def test_smc_stops_at_max_stages():
    _, _, tp, tl = _gauss_problem(y=30.0)
    gen = torch.Generator().manual_seed(4)
    res = ts.smc_run(tp, tl, torch.randn(50, 2, generator=gen, dtype=torch.float64), gen,
                     n_mutation_steps=1, max_stages=2)
    assert res.n_stages == 2 and float(res.temperatures[-1]) < 1.0
