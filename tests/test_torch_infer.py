"""PyTorch port, the sampler: ``infer/hmc.py``, ``infer/dense_metric.py`` and
``infer/nuts.py`` against their JAX counterparts on the same numpy inputs
(CPU float64), the NUTS transition against the JAX transition on the same
pre-drawn random numbers, and the sampler on analytic targets.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcsd_tpu.infer import dense_metric as jdm
from gpcsd_tpu.infer import hmc as jh
from gpcsd_tpu.infer import nuts as jn
from gpcsd_tpu_torch.infer import dense_metric as tdm
from gpcsd_tpu_torch.infer import hmc as th
from gpcsd_tpu_torch.infer import nuts as tn

torch.set_num_threads(2)

#: same float64 formulas on the same inputs in both packages
TOL = dict(rtol=1e-12, atol=1e-12)


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(kw or TOL))


# ---------------------------------------------------------------- hmc.py


def test_da_update_matches_jax():
    """Four chains with their own acceptance histories, 30 updates."""
    rng = np.random.default_rng(0)
    acc = rng.uniform(0.0, 1.0, size=(30, 4))
    step0 = np.array([0.5, 1.0, 2.0, 1e-3])
    ts = th.da_init(T(step0))
    js = [jh.da_init(s) for s in step0]
    for a in acc:
        ts = th.da_update(ts, T(a), target=0.8)
        js = [jh.da_update(s, jnp.asarray(ai), target=0.8) for s, ai in zip(js, a)]
    for field in ("log_step", "log_step_avg", "h_sum", "mu"):
        close(getattr(ts, field), [getattr(s, field) for s in js])
    assert ts.count.tolist() == [30] * 4


def test_welford_matches_jax():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(50, 3, 4)) * np.array([1.0, 2.0, 0.5, 10.0])
    ts = th.welford_init(4, (3,), device="cpu")
    js = [jh.welford_init(4) for _ in range(3)]
    for x in xs:
        ts = th.welford_update(ts, T(x))
        js = [jh.welford_update(s, jnp.asarray(xc)) for s, xc in zip(js, x)]
    close(ts.mean, [s.mean for s in js])
    close(ts.m2, [s.m2 for s in js])
    for reg in (True, False):
        close(th.welford_variance(ts, regularize=reg),
              [jh.welford_variance(s, regularize=reg) for s in js])
    close(th.welford_variance(ts, regularize=False), xs.var(0, ddof=1), rtol=1e-10)
    empty = th.welford_variance(th.welford_init(4, (3,), device="cpu"))
    close(empty, [jh.welford_variance(jh.welford_init(4))] * 3)


def _spd(rng, dim, n=1):
    a = rng.normal(size=(n, dim, dim))
    return a @ np.swapaxes(a, 1, 2) + 0.5 * np.eye(dim)


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_velocity_kinetic_momentum_leapfrog_match_jax(dense):
    """mass_velocity, kinetic, draw_momentum and leapfrog for three chains
    with different metrics, against the JAX functions chain by chain."""
    rng = np.random.default_rng(2)
    C, dim = 3, 5
    inv_mass = _spd(rng, dim, C) if dense else rng.uniform(0.2, 3.0, size=(C, dim))
    r, z, xi = (rng.normal(size=(C, dim)) for _ in range(3))
    prec = _spd(rng, dim)[0]
    step = np.array([0.3, -0.2, 0.05])

    close(th.mass_velocity(T(inv_mass), T(r)),
          [jh.mass_velocity(jnp.asarray(m), jnp.asarray(x)) for m, x in zip(inv_mass, r)])
    close(th.kinetic(T(r), T(inv_mass)),
          [jh.kinetic(jnp.asarray(x), jnp.asarray(m)) for m, x in zip(inv_mass, r)])
    # the JAX draw takes a key: feed it this test's xi through a stub
    want = []
    for m, x in zip(inv_mass, xi):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal", lambda key, shape, dtype, x=x: jnp.asarray(x))
            want.append(jh.draw_momentum(None, jnp.asarray(m), (dim,), jnp.float64))
    close(th.draw_momentum(T(xi), T(inv_mass)), want)

    def jlp(u):
        return -0.5 * u @ jnp.asarray(prec) @ u

    def tvg(u):
        return -0.5 * torch.sum(u * (u @ T(prec)), dim=-1), -(u @ T(prec))

    jvga = jh.as_aux_vga(jax.value_and_grad(jlp))
    grad = -(z @ prec)
    got = th.leapfrog(tvg, T(z), T(r), T(grad), T(step), T(inv_mass))
    for c in range(C):
        wz, wr, wl, wg, _ = jh.leapfrog(jvga, jnp.asarray(z[c]), jnp.asarray(r[c]),
                                        jnp.asarray(grad[c]), (), step[c],
                                        jnp.asarray(inv_mass[c]))
        for g, w in zip(got, (wz, wr, wl, wg)):
            close(g[c], w)


@pytest.mark.parametrize("n", [10, 60, 150, 1000])
def test_stan_warmup_schedule_matches_jax(n):
    for a, b in zip(th.stan_warmup_schedule(n), jh.stan_warmup_schedule(n)):
        np.testing.assert_array_equal(a, b)


def test_find_reasonable_step_size_matches_jax():
    """Chains that must double and chains that must halve, in one batch."""
    scales = np.array([[1.0, 1.0], [1e-3, 1e-3], [50.0, 80.0], [0.1, 5.0]])
    z = np.array([[0.5, -0.3], [1e-3, 2e-3], [10.0, -30.0], [0.05, 1.0]])
    xi = np.random.default_rng(3).normal(size=(4, 2))

    def tvg(u, s=None):
        s = T(scales) if s is None else s
        return -0.5 * torch.sum(torch.square(u / s), dim=-1), -u / torch.square(s)

    got = th.find_reasonable_step_size(tvg, T(z), T(xi), torch.ones(4, 2, dtype=torch.float64))
    for c in range(4):
        jvga = jh.as_aux_vga(jax.value_and_grad(
            lambda u, c=c: -0.5 * jnp.sum((u / jnp.asarray(scales[c])) ** 2)))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "normal", lambda key, shape, dtype, c=c: jnp.asarray(xi[c]))
            want = jh.find_reasonable_step_size(jvga, jnp.asarray(z[c]), None, jnp.ones(2))
        assert float(got[c]) == float(want)
    assert len(set(got.tolist())) > 2  # the chains did stop at different steps


# ------------------------------------------------------- dense_metric.py


def test_dense_welford_matches_jax_and_merges():
    rng = np.random.default_rng(4)
    cov = _spd(rng, 4)[0]
    xs = rng.multivariate_normal(np.zeros(4), cov, size=(60, 2))  # 60 draws x 2 chains
    ts = tdm.dense_welford_init(4, (2,), device="cpu")
    js = [jdm.dense_welford_init(4) for _ in range(2)]
    for x in xs:
        ts = tdm.dense_welford_update(ts, T(x))
        js = [jdm.dense_welford_update(s, jnp.asarray(xc)) for s, xc in zip(js, x)]
    close(ts.mean, [s.mean for s in js])
    close(ts.m2, [s.m2 for s in js])
    for reg in (True, False):
        close(tdm.dense_welford_cov(ts, regularize=reg),
              [jdm.dense_welford_cov(s, regularize=reg) for s in js])
    close(tdm.dense_welford_cov(ts, regularize=False)[0], np.cov(xs[:, 0].T), rtol=1e-10)
    # merge of the two chains' accumulators, against JAX and a single stream
    a = tdm.DenseWelfordState(ts.count[0], ts.mean[0], ts.m2[0])
    b = tdm.DenseWelfordState(ts.count[1], ts.mean[1], ts.m2[1])
    merged, jmerged = tdm.dense_welford_merge(a, b), jdm.dense_welford_merge(*js)
    close(merged.mean, jmerged.mean)
    close(merged.m2, jmerged.m2)
    close(tdm.dense_welford_cov(merged, regularize=False),
          np.cov(xs.reshape(-1, 4).T), rtol=1e-10)
    # an empty accumulator merges as the identity
    empty = tdm.dense_welford_init(4, device="cpu")
    close(tdm.dense_welford_merge(empty, a).m2, a.m2)


def test_metric_ops_match_jax():
    rng = np.random.default_rng(5)
    cov = _spd(rng, 6, 2)
    r, xi = rng.normal(size=(2, 6)), rng.normal(size=(2, 6))
    L = tdm.metric_from_cov(T(cov))
    jL = [jdm.metric_from_cov(jnp.asarray(c)) for c in cov]
    close(L, jL)
    close(tdm.velocity(L, T(r)), [jdm.velocity(l, jnp.asarray(x)) for l, x in zip(jL, r)])
    close(tdm.kinetic(L, T(r)), [jdm.kinetic(l, jnp.asarray(x)) for l, x in zip(jL, r)])
    want = [jax.scipy.linalg.solve_triangular(l.T, jnp.asarray(x), lower=False)
            for l, x in zip(jL, xi)]
    close(tdm.draw_momentum(T(xi), L), want)
    # singular covariance: the trace-scaled jitter keeps the factor finite
    assert torch.isfinite(tdm.metric_from_cov(torch.ones(3, 3, dtype=torch.float64))).all()


# ---------------------------------------------------------------- nuts.py


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_pool_welford_chains_matches_jax(dense):
    rng = np.random.default_rng(6)
    C, dim = 4, 3
    mean = rng.normal(size=(C, dim))
    if dense:
        m2 = _spd(rng, dim, C)
        jwf = jdm.DenseWelfordState(count=jnp.full((C,), 17.0), mean=jnp.asarray(mean),
                                    m2=jnp.asarray(m2))
        twf = tdm.DenseWelfordState(count=torch.full((C,), 17.0, dtype=torch.float64),
                                    mean=T(mean), m2=T(m2))
    else:
        m2 = rng.uniform(1.0, 5.0, size=(C, dim))
        jwf = jh.WelfordState(mean=jnp.asarray(mean), m2=jnp.asarray(m2),
                              count=jnp.full((C,), 17, jnp.int32))
        twf = th.WelfordState(mean=T(mean), m2=T(m2),
                              count=torch.full((C,), 17, dtype=torch.int64))
    got, want = tn._pool_welford_chains(twf), jn._pool_welford_chains(jwf)
    assert type(got) is type(twf)
    close(got.mean, want.mean)
    close(got.m2, want.m2)
    assert got.count.tolist() == [17] * C


GUARD_CASES = {
    "collapsed_chains_repaired": [0.4, 1e-9, 0.2, 3e-10],
    "healthy_untouched": [0.4, 0.3, 0.2, 0.25],
    "majority_collapse": [1e-9, 2e-9, 0.4, 3e-10],
    "all_collapsed_alike": [1e-9, 2e-9, 1.5e-9, 3e-9],
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_stepsize_floor_guard_matches_jax(case):
    """The same carry through both guards: same rows repaired from the same
    donor, healthy rows untouched, the carry itself returned when no chain
    is sick."""
    steps = np.array(GUARD_CASES[case])
    C, dim = 4, 3
    rng = np.random.default_rng(7)
    z, grad, wfm = (rng.normal(size=(C, dim)) for _ in range(3))
    logp = rng.normal(size=C)
    inv_mass = rng.normal(size=(C, dim, dim))
    ls = np.log(steps)
    jda = jh.DualAveragingState(jnp.asarray(ls), jnp.asarray(ls), jnp.zeros(C),
                                jnp.asarray(ls + np.log(10.0)), jnp.zeros(C, jnp.int32))
    tda = th.DualAveragingState(T(ls), T(ls), torch.zeros(C, dtype=torch.float64),
                                T(ls + np.log(10.0)), torch.zeros(C, dtype=torch.int64))
    jwf = jh.WelfordState(jnp.asarray(wfm), jnp.asarray(wfm) ** 2, jnp.full((C,), 5, jnp.int32))
    twf = th.WelfordState(T(wfm), T(wfm) ** 2, torch.full((C,), 5, dtype=torch.int64))
    jcarry = (jnp.asarray(z), jnp.asarray(logp), jnp.asarray(grad), jda, jwf,
              jnp.asarray(inv_mass), ())
    tcarry = (T(z), T(logp), T(grad), tda, twf, T(inv_mass))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jfixed = jn.stepsize_floor_guard(jcarry, C, chunk=3)
        tfixed = tn.stepsize_floor_guard(tcarry, C, at=3)
    repaired = case in ("collapsed_chains_repaired", "majority_collapse")
    assert sum("floor guard" in str(w.message) for w in caught) == (2 if repaired else 0)
    assert (tfixed is tcarry) == (not repaired)
    for i in (0, 1, 2, 5):
        close(tfixed[i], jfixed[i])
    for field in ("log_step", "log_step_avg", "mu"):
        close(getattr(tfixed[3], field), getattr(jfixed[3], field))
    close(tfixed[4].m2, jfixed[4].m2)
    if repaired:  # the inputs are not written to
        close(tcarry[0], z)


def jax_noise(key, dim, max_depth):
    """The random numbers ``gpcsd_tpu.infer.nuts.nuts_transition`` draws
    from ``key``, laid out as the port's TransitionNoise for one chain."""
    key_mom, key_dir, key_sub, key_acc = jax.random.split(key, 4)
    xi = jax.random.normal(key_mom, (dim,), jnp.float64)
    dirs = jax.random.rademacher(key_dir, (max_depth,), jnp.int32)
    nleaf = 2 ** (max_depth - 1)
    u_leaf = [[jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key_sub, d), n),
                                  dtype=jnp.float64) for n in range(nleaf)]
              for d in range(max_depth)]
    u_doubling = [jax.random.uniform(jax.random.fold_in(key_acc, d), dtype=jnp.float64)
                  for d in range(max_depth)]
    return [np.asarray(a, dtype=np.float64) for a in (xi, dirs, u_leaf, u_doubling)]


PREC5 = np.linalg.inv(0.6 * np.ones((5, 5)) + 0.4 * np.diag([1.0, 2.0, 0.5, 3.0, 1.5]))


def gaussian_j(u):
    return -0.5 * u @ jnp.asarray(PREC5) @ u


def gaussian_t(u):
    return -0.5 * torch.sum(u * torch.sum(T(PREC5) * u[:, None, :], dim=-1), dim=-1)


def banana_j(u):
    return -0.5 * (u[0] ** 2 / 4.0 + jnp.sum((u[1:] - 0.5 * u[0] ** 2) ** 2) / 0.25)


def banana_t(u):
    bend = u[:, 1:] - 0.5 * torch.square(u[:, :1])
    return -0.5 * (torch.square(u[:, 0]) / 4.0 + torch.sum(torch.square(bend), dim=-1) / 0.25)


TARGETS = {"gaussian": (gaussian_j, gaussian_t), "banana": (banana_j, banana_t)}


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
@pytest.mark.parametrize("target,step", [("gaussian", 0.35), ("banana", 0.12), ("banana", 1.5)])
def test_transition_matches_jax_on_same_random_numbers(target, step, dense):
    """20 seeds as 20 chains of ONE batched transition of the port, each
    fed the numbers the JAX transition draws from its key, against 20
    single-chain JAX transitions: equal ``num_steps``, ``depth`` and
    ``diverging``, and ``z'``, ``logp'``, ``accept_prob`` to 1e-9 (the same
    float64 trajectory summed in another order).  The chains stop at
    different leaves, so this also holds the lock-step masking to the
    semantics of ``vmap`` over ``while_loop``.  The banana at step 1.5
    reaches divergent and max-depth trees."""
    jlp, tlp = TARGETS[target]
    dim, max_depth, nseeds = 5, 5, 20
    rng = np.random.default_rng(8)
    z0 = rng.normal(size=(nseeds, dim)) * (0.3 if target == "banana" else 1.0)
    inv_mass = _spd(rng, dim)[0] / 3.0 if dense else rng.uniform(0.5, 2.0, size=dim)
    keys = jax.random.split(jax.random.PRNGKey(11), nseeds)
    jvga = jh.as_aux_vga(jax.value_and_grad(jlp))

    def jtrans(z, key):
        logp, grad, _ = jvga(z, ())
        zn, lpn, _, stats, _ = jn.nuts_transition(
            jvga, z, logp, grad, key, step, jnp.asarray(inv_mass), max_depth=max_depth)
        return zn, lpn, stats

    jz, jlogp, jstats = jax.jit(jax.vmap(jtrans))(jnp.asarray(z0), keys)

    noise = tn.TransitionNoise(*(T(np.stack(f)) for f in
                                 zip(*(jax_noise(k, dim, max_depth) for k in keys))))
    vg = lambda u: tn.value_and_grad_rows(tlp, u)  # noqa: E731
    logp0, grad0 = vg(T(z0))
    tz, tlogp, _, tstats = tn.nuts_transition(
        vg, T(z0), logp0, grad0, noise, torch.full((nseeds,), step, dtype=torch.float64),
        T(np.broadcast_to(inv_mass, (nseeds,) + inv_mass.shape).copy()), max_depth=max_depth)

    np.testing.assert_array_equal(tstats.num_steps.numpy(), np.asarray(jstats.num_steps))
    np.testing.assert_array_equal(tstats.depth.numpy(), np.asarray(jstats.depth))
    np.testing.assert_array_equal(tstats.diverging.numpy(), np.asarray(jstats.diverging))
    close(tz, jz, rtol=1e-9, atol=1e-9)
    close(tlogp, jlogp, rtol=1e-9, atol=1e-9)
    close(tstats.accept_prob, jstats.accept_prob, rtol=1e-9, atol=1e-9)
    close(tstats.energy, jstats.energy, rtol=1e-9, atol=1e-9)
    assert len(set(tstats.num_steps.tolist())) > 1  # trees of different sizes in the batch
    if step > 1.0:
        assert tstats.diverging.any() and not tstats.diverging.all()


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_batched_chains_equal_single_chains_bitwise(dense):
    """A chain's draws do not depend on which chains share its batch: four
    chains run together equal the same four run one at a time, bit for bit
    (CPU), warmup adaptation included."""
    u0s = T(np.random.default_rng(9).normal(size=(4, 5)))
    kw = dict(num_warmup=40, num_samples=15, max_depth=5, dense_mass=dense)
    together = tn.nuts_chains(gaussian_t, u0s, tn.chain_generators(3, 4), **kw)
    for c in range(4):
        alone = tn.nuts_chains(gaussian_t, u0s[c:c + 1], tn.chain_generators(3, 4)[c:c + 1], **kw)
        for a, b in zip(together, alone):
            assert torch.equal(a[c], b[0])
    single = tn.nuts_run(gaussian_t, u0s[2], tn.chain_generators(3, 4)[2], **kw)
    assert torch.equal(single.samples, together.samples[2])
    assert single.inv_mass.shape == ((5, 5) if dense else (5,))


# ------------------------------------------------------ analytic targets


def test_correlated_gaussian_moments():
    """4 x (300 + 1000) draws of a correlated 2-d Gaussian (seed 0): mean
    within 0.15, covariance within 0.25 (the JAX package's tolerances for
    its 4 x 1500 draws), under 1% divergent."""
    cov = np.array([[2.0, 1.2], [1.2, 1.0]])
    prec = T(np.linalg.inv(cov))

    def lp(u):
        return -0.5 * torch.sum(u * (u @ prec), dim=-1)

    u0s = T(np.random.default_rng(1).normal(size=(4, 2)))
    res = tn.nuts_chains(lp, u0s, tn.chain_generators(0, 4), num_warmup=300, num_samples=1000)
    s = res.samples.reshape(-1, 2).numpy()
    assert np.abs(s.mean(0)).max() < 0.15
    assert np.allclose(np.cov(s.T), cov, atol=0.25)
    assert res.diverging.double().mean() < 0.01
    assert res.samples.shape == (4, 1000, 2) and res.step_size.shape == (4,)


def test_scale_mismatch_mass_adaptation():
    """Badly scaled target: mass adaptation must recover the scales (sd
    within 25%, as the JAX test; 2 x (300 + 500), seed 2)."""
    scales = T([0.05, 1.0, 30.0])

    def lp(u):
        return -0.5 * torch.sum(torch.square(u / scales), dim=-1)

    res = tn.nuts_chains(lp, torch.zeros(2, 3, dtype=torch.float64), tn.chain_generators(2, 2),
                         num_warmup=300, num_samples=500)
    s = res.samples.reshape(-1, 3).numpy()
    assert np.allclose(s.std(0), scales.numpy(), rtol=0.25)
    assert (res.inv_mass[:, 2] > res.inv_mass[:, 0]).all()  # inverse mass ~ variances


def test_dense_metric_recovers_moments_and_shortens_trees():
    """On a correlated Gaussian the adapted full-covariance metric recovers
    the covariance (within 0.35) with trajectories under 0.7 of the
    diagonal metric's length (the JAX test's bounds; 2 x (300 + 600))."""
    cov = np.array([[2.0, 1.2, 0.0], [1.2, 1.0, 0.3], [0.0, 0.3, 0.5]])
    prec = T(np.linalg.inv(cov))

    def lp(u):
        return -0.5 * torch.sum(u * (u @ prec), dim=-1)

    u0 = torch.zeros(2, 3, dtype=torch.float64)
    kw = dict(num_warmup=300, num_samples=600)
    dense = tn.nuts_chains(lp, u0, tn.chain_generators(0, 2), dense_mass=True, **kw)
    diag = tn.nuts_chains(lp, u0, tn.chain_generators(0, 2), **kw)
    assert dense.inv_mass.shape == (2, 3, 3)
    assert np.allclose(np.cov(dense.samples.reshape(-1, 3).numpy().T), cov, atol=0.35)
    assert dense.num_steps.double().mean() < 0.7 * diag.num_steps.double().mean()


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_pooled_warmup_shares_metric(dense):
    """pool_warmup: chains share Welford statistics, so the adapted metrics
    are closer across chains than without pooling, reflect the true
    variances (0.25, 16, 1), and the moments hold (variance within 35%)."""
    scales = T([0.5, 4.0, 1.0])

    def lp(u):
        return -0.5 * torch.sum(torch.square(u / scales), dim=-1)

    u0s = T(np.random.default_rng(3).normal(size=(4, 3)))
    kw = dict(num_warmup=300, num_samples=300, dense_mass=dense)
    pooled = tn.nuts_chains(lp, u0s, tn.chain_generators(0, 4), pool_warmup=True, **kw)
    alone = tn.nuts_chains(lp, u0s, tn.chain_generators(0, 4), pool_warmup=False, **kw)

    def diag(res):
        im = res.inv_mass.numpy()
        return np.diagonal(im, axis1=1, axis2=2) if dense else im

    spread = lambda res: float(np.mean(np.std(np.log(diag(res)), axis=0)))  # noqa: E731
    assert spread(pooled) < spread(alone)
    im = diag(pooled).mean(axis=0)
    assert im[0] < im[2] < im[1]
    s = pooled.samples.reshape(-1, 3).numpy()
    assert np.allclose(s.var(axis=0), scales.numpy() ** 2, rtol=0.35)


def test_callback_and_generator_count():
    seen = []
    lp = lambda u: -0.5 * torch.sum(torch.square(u), dim=-1)  # noqa: E731
    u0s = torch.zeros(2, 2, dtype=torch.float64)
    tn.nuts_chains(lp, u0s, tn.chain_generators(0, 2), num_warmup=3, num_samples=2,
                   callback=lambda i, carry: seen.append((i, len(carry))))
    assert seen == [(i, 6) for i in range(5)]
    with pytest.raises(ValueError, match="generators"):
        tn.nuts_chains(lp, u0s, tn.chain_generators(0, 3), num_warmup=1, num_samples=1)


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_adapt_mass_off_and_init_step_size(dense):
    """``adapt_mass=False`` keeps the metric the identity through warmup, as
    the JAX sampler's does, where the default adapts it to the scales;
    ``init_step_size`` is where the step-size search starts, so the step of
    a run without warmup is that start times a power of two."""
    scales = T([0.5, 1.0, 2.0])

    def lp(u):
        return -0.5 * torch.sum(torch.square(u / scales), dim=-1)

    u0s = torch.zeros(2, 3, dtype=torch.float64)
    kw = dict(num_warmup=100, num_samples=5, max_depth=4, dense_mass=dense)
    fixed = tn.nuts_chains(lp, u0s, tn.chain_generators(0, 2), adapt_mass=False, **kw)
    adapted = tn.nuts_chains(lp, u0s, tn.chain_generators(0, 2), **kw)
    eye = torch.eye(3, dtype=torch.float64) if dense else torch.ones(3, dtype=torch.float64)
    assert torch.equal(fixed.inv_mass, eye.expand_as(fixed.inv_mass))
    assert not torch.equal(adapted.inv_mass, eye.expand_as(adapted.inv_mass))
    start = tn.nuts_chains(lp, u0s, tn.chain_generators(0, 2), num_warmup=0, num_samples=1,
                           init_step_size=0.3)
    powers = np.log2(start.step_size.numpy() / 0.3)
    np.testing.assert_allclose(powers, np.round(powers), atol=1e-9)
