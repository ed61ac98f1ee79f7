"""PyTorch port, ``infer/model_comparison.py``: WAIC, PSIS and the
generalized-Pareto fit against the JAX module on the same matrices, and
the per-trial log-likelihood against the JAX function and against the
port's own ``loglik`` (CPU float64).
"""

import numpy as np
import pytest
import torch

from gpcsd_tpu.infer import model_comparison as jmc
from gpcsd_tpu_torch.infer import model_comparison as tmc
from torch_port_helpers import jax_small_model, port_of

torch.set_num_threads(2)


def _ll_matrix(seed, S=240, n=12):
    """Pointwise terms with tails of different weight per column."""
    rng = np.random.default_rng(seed)
    return -3.0 + rng.normal(size=(S, n)) * np.linspace(0.1, 2.0, n) \
        - rng.pareto(3.0, size=(S, n)) * np.linspace(0.0, 0.5, n)


def _same(got, want, tol=1e-10):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_waic_and_loo_match_jax(seed):
    """Every entry of both result dicts to 1e-10 (numpy and scipy's
    logsumexp against jax.scipy's on the same float64 matrix)."""
    ll = _ll_matrix(seed)
    _same(tmc.waic(ll), jmc.waic(ll))
    _same(tmc.psis_loo(ll), jmc.psis_loo(ll))


def test_psislw_matches_jax_and_is_normalized():
    ll = _ll_matrix(2)
    lw, k = tmc.psislw(-ll)
    jlw, jk = jmc.psislw(-ll)
    np.testing.assert_allclose(lw, jlw, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(k, jk, rtol=1e-10)
    np.testing.assert_allclose(np.exp(lw).sum(axis=0), 1.0, rtol=1e-12)
    # too few draws for a tail fit: k-hat is inf, the weights stay normalized
    lw_few, k_few = tmc.psislw(-ll[:10])
    assert np.isinf(k_few).all() and np.allclose(np.exp(lw_few).sum(axis=0), 1.0)
    np.testing.assert_array_equal(k_few, jmc.psislw(-ll[:10])[1])


def test_gpdfit_matches_jax_and_recovers_k():
    rng = np.random.default_rng(3)
    k_true, sigma = 0.3, 2.0
    x = np.sort(sigma * ((1 - rng.uniform(size=4000)) ** (-k_true) - 1) / k_true)
    got, want = tmc._gpdfit(x), jmc._gpdfit(x)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert abs(got[0] - k_true) < 0.05
    for p in (0.1, 0.9):
        assert tmc._gpd_quantile(p, *got) == jmc._gpd_quantile(p, *want)
    assert tmc._gpd_quantile(0.5, 0.0, 2.0) == pytest.approx(2.0 * np.log(2.0))


@pytest.mark.parametrize("kind", ["waic", "loo"])
def test_compare_matches_jax(kind):
    fn_t, fn_j = (tmc.waic, jmc.waic) if kind == "waic" else (tmc.psis_loo, jmc.psis_loo)
    lls = {"a": _ll_matrix(4), "b": _ll_matrix(5) - 0.3, "c": _ll_matrix(6) + 0.2}
    got = tmc.compare({k: fn_t(v) for k, v in lls.items()})
    want = jmc.compare({k: fn_j(v) for k, v in lls.items()})
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[1:], w[1:], rtol=1e-10, atol=1e-10)
    assert got[0][2] == 0.0 and got[0][3] == 0.0


@pytest.mark.parametrize("noise", ["scalar", "per_channel_approx", "per_channel_exact"])
def test_pointwise_loglik_matches_jax_and_sums_to_loglik(noise):
    """Per-trial terms against the JAX function to 1e-9 relative, for a
    number of draws that is no multiple of the batch; their sum over trials
    equals ``loglik`` plus the 2 pi constant to 1e-11."""
    jm = jax_small_model("exact" if noise.endswith("exact") else "approx", noise != "scalar")
    tm = port_of(jm)
    jf, tf = jm._fns(), tm._fns()
    u0 = np.asarray(jf.param_set.pack(jm._theta()))
    us = u0[None] + 0.2 * np.random.default_rng(7).normal(size=(5, u0.size))
    got = tmc.pointwise_loglik(tf, us, tm._Y(), batch=2)
    want = jmc.pointwise_loglik(jf, us, jm._Y(), batch=2)
    assert got.shape == (5, 4) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.testing.assert_array_equal(got, tmc.pointwise_loglik(tf, torch.tensor(us), tm._Y(), batch=8))
    nx, nt, ntrials = 6, 10, 4
    total = np.array([float(tf.loglik(tf.param_set.unpack(torch.tensor(u)), tm._Y())) for u in us])
    np.testing.assert_allclose(got.sum(axis=1), total - 0.5 * ntrials * nx * nt * np.log(2 * np.pi),
                               rtol=1e-11)
