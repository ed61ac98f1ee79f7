"""PyTorch port, ``parallel/``: the (chain, trial) mesh, the trial-sharded
log-joint and the sharded drivers, on four gloo ranks on the CPU.

The model is ``tests/test_parallel.py``'s (nx=8, nt=12, 10 trials, ngl=30),
and a per-channel ``het_noise="exact"`` twin of it.  The ranks are spawned
once for the whole file (``torch_parallel_worker.py``, which imports no
JAX) and rendezvous through a file under the test's temporary directory;
every test reads their results.  The sharded log-joint is held against the
JAX package's unsharded ``log_prob`` and ``jax.grad`` with
``test_parallel.py``'s tolerances (value 1e-10, gradient 1e-8); each driver
against the port's unsharded driver on the same starts and random numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpcsd_tpu as g
import torch_parallel_worker as W
from gpcsd_tpu.parallel.mesh import pad_to_multiple as j_pad_to_multiple
from gpcsd_tpu_torch.infer.advi import advi_fit
from gpcsd_tpu_torch.infer.lbfgs import lbfgs_minimize
from gpcsd_tpu_torch.infer.map import sample_restarts
from gpcsd_tpu_torch.infer.nuts import chain_generators, nuts_chains
from gpcsd_tpu_torch.infer.smc import smc_run
from gpcsd_tpu_torch.models.inference_api import prior_starts, stream_generator
from gpcsd_tpu_torch.parallel.mesh import pad_to_multiple

WORLD = 4


def jax_model(het_exact=False, nx=8, nt=12, ntrials=10):
    """``test_parallel.make_model``; with ``het_exact``, per-channel noise
    under the exact heteroscedastic likelihood."""
    rng = np.random.default_rng(42)
    x = (np.arange(nx) * 100.0).reshape(-1, 1)
    t = np.arange(nt).reshape(-1, 1) * 1.0
    kw = dict(het_noise="exact", sig2n_prior=[g.HalfNormal(0.1) for _ in range(nx)]) \
        if het_exact else {}
    m = g.GPCSD1D(rng.normal(size=(nx, nt, ntrials)), x, t, ngl=30, **kw)
    m.R["value"] = 120.0
    m.spatial_cov.params["ell"]["value"] = 180.0
    m.temporal_cov_list[0].params["ell"]["value"] = 5.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 0.8
    m.temporal_cov_list[1].params["ell"]["value"] = 2.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.4
    m.sig2n["value"] = rng.uniform(0.03, 0.08, size=nx) if het_exact else 0.05
    return m


def spec_of(jm):
    prior = jm.sig2n["prior"]
    sd = [p.sd for p in prior] if isinstance(prior, list) else prior.sd
    return dict(lfp=np.asarray(jm.lfp), x=np.asarray(jm.x), t=np.asarray(jm.t),
                theta={k: np.asarray(v) for k, v in jm._theta().items()}, a=jm.a, b=jm.b,
                ngl=jm.ngl, prior_sd=sd, het_noise=jm.het_noise)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX models, the points, the JAX values and gradients there, and
    the four ranks' results."""
    jms = {"plain": jax_model(), "hetx": jax_model(het_exact=True)}
    us, want = {}, {}
    for name, jm in jms.items():
        fns = jm._fns()
        u0 = np.asarray(fns.param_set.pack(jm._theta()))
        us[name] = np.vstack([u0, u0 + 0.05 * np.random.default_rng(1).normal(size=(2, u0.size))])
        vg = jax.jit(jax.vmap(jax.value_and_grad(fns.log_prob), (0, None)))
        want[name] = tuple(np.asarray(a) for a in vg(jnp.asarray(us[name]), jm._Y()))
    specs = {name: spec_of(jm) for name, jm in jms.items()}
    init_file = str(tmp_path_factory.mktemp("dist") / "rendezvous")
    ranks = W.spawn(WORLD, init_file, specs, us)
    port = W.model_from_spec(specs["plain"])
    return {"us": us, "want": want, "ranks": ranks, "port": port}


def test_make_mesh_shapes_and_refusals(case):
    for r in case["ranks"]:
        assert r["mesh_default"] == (4, 1)
        assert r["mesh_trial2"] == (2, 2)
        assert r["mesh_refused"] == [True, True, True]
    assert [r["coord21"] for r in case["ranks"]] == [(0, 0), (1, 0), None, None]


def test_pad_to_multiple_matches_jax():
    Y = np.random.default_rng(0).normal(size=(10, 3, 4))
    for multiple in (1, 3, 4, 5, 16):
        got, n = pad_to_multiple(Y, multiple)
        want, n_want = j_pad_to_multiple(Y, multiple)
        assert n == n_want == 10
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("label,name,block", [
    ("plain22", "plain", 5),    # (chain=2, trial=2): 10 trials in blocks of 5
    ("plain14", "plain", 3),    # (1, 4): padded to 12, the last block holds one zero trial
    ("hetx14", "hetx", 3),      # the same with the exact per-channel noise log-det offset
])
def test_sharded_log_prob_matches_jax(case, label, name, block):
    """Value and gradient on every rank equal JAX's unsharded ``log_prob``
    and ``jax.grad`` (``test_parallel.py``'s tolerances).  A gradient that
    all-reduced its cotangent as well as its value
    (``torch.distributed.nn.functional.all_reduce``) would be the group
    size times each rank's local gradient, and would miss JAX's."""
    v_want, g_want = case["want"][name]
    first = case["ranks"][0][label]
    for r in case["ranks"]:
        v, gr, shape = r[label]
        assert shape == (block, 8, 12)
        np.testing.assert_allclose(v, v_want, rtol=1e-10, atol=0)
        np.testing.assert_allclose(gr, g_want, rtol=1e-8, atol=1e-8)
        # every rank of a trial group holds the same reduced bits
        np.testing.assert_array_equal(v, first[0])
        np.testing.assert_array_equal(gr, first[1])


def test_map_fit_sharded_matches_batched_lbfgs(case):
    """(chain=2, trial=1): 3 restarts padded to 4, each rank's 2 in one
    batched L-BFGS, equal bit for bit to one batched L-BFGS of all 4 from
    the same starts (with one trial rank the sharded log-joint is
    ``log_prob``'s arithmetic).  Ranks outside the mesh get None."""
    fns, Y = case["port"]._fns(), case["port"]._Y()
    lo, hi = fns.param_set.bounds()
    u0s = sample_restarts(fns.param_set, np.random.default_rng(W.MAP["seed"]), 4)
    res = lbfgs_minimize(lambda u: -fns.log_prob(u, Y), torch.as_tensor(u0s), lo=lo, hi=hi,
                         max_iter=W.MAP["maxiter"])
    want = torch.where(res.failed, torch.inf, res.f).numpy()
    assert np.isfinite(want).all()
    ranks = case["ranks"]
    assert ranks[2]["map21"] is None and ranks[3]["map21"] is None
    for r in ranks[:2]:
        u_all, nll_all = r["map21"]
        np.testing.assert_array_equal(nll_all, want)
        np.testing.assert_array_equal(u_all, res.u.numpy())


def test_map_fit_sharded_init_overrides(case):
    """``init_overrides`` pins R in every restart's start, as
    ``sample_restarts(fixed=)`` does: at (chain=2, trial=1) the result
    equals, bit for bit, one batched L-BFGS from those starts."""
    fns, Y = case["port"]._fns(), case["port"]._Y()
    lo, hi = fns.param_set.bounds()
    u0s = sample_restarts(fns.param_set, np.random.default_rng(W.MAP["seed"]), 4, fixed=W.PINNED)
    free = sample_restarts(fns.param_set, np.random.default_rng(W.MAP["seed"]), 4)
    r_col = fns.param_set._offsets["R"][0]
    pinned = np.log(150.0 / fns.param_set.specs["R"].scale)
    assert lo[r_col] < pinned < hi[r_col] and np.all(u0s[:, r_col] == pinned)
    np.testing.assert_array_equal(np.delete(u0s, r_col, axis=1), np.delete(free, r_col, axis=1))
    res = lbfgs_minimize(lambda u: -fns.log_prob(u, Y), torch.as_tensor(u0s), lo=lo, hi=hi,
                         max_iter=W.MAP["maxiter"])
    ranks = case["ranks"]
    assert ranks[2]["map21_pinned"] is None and ranks[3]["map21_pinned"] is None
    for r in ranks[:2]:
        u_all, nll_all = r["map21_pinned"]
        np.testing.assert_array_equal(nll_all, torch.where(res.failed, torch.inf, res.f).numpy())
        np.testing.assert_array_equal(u_all, res.u.numpy())
    assert not np.array_equal(ranks[0]["map21_pinned"][0], ranks[0]["map21"][0])


def test_map_fit_sharded_over_trials(case):
    """(chain=2, trial=2): every rank returns the same restarts, each no
    higher than its start, and the NLL it reports is ``-log_prob`` at the
    ``u`` it reports.  (The path itself is not compared with the unsharded
    run: a sum over two trial blocks rounds differently from one over all
    trials, and these prior starts end at exhausted line searches, whose
    outcome moves with the last bits.)"""
    fns, Y = case["port"]._fns(), case["port"]._Y()
    u0s = sample_restarts(fns.param_set, np.random.default_rng(W.MAP["seed"]), 4)
    with torch.no_grad():
        start = -fns.log_prob(torch.as_tensor(u0s), Y).numpy()
    u_all, nll_all = case["ranks"][0]["map22"]
    with torch.no_grad():
        at_u = -fns.log_prob(torch.as_tensor(u_all), Y).numpy()
    assert np.all(nll_all <= start)
    np.testing.assert_allclose(nll_all, at_u, rtol=1e-10, atol=0)
    for r in case["ranks"][1:]:
        np.testing.assert_array_equal(r["map22"][0], u_all)
        np.testing.assert_array_equal(r["map22"][1], nll_all)


def test_nuts_sharded_matches_unsharded_chains(case):
    """Chains (4) split over 2 chain ranks equal the unsharded 4-chain run
    of the same starts and generators; ranks outside the mesh get None."""
    fns, Y = case["port"]._fns(), case["port"]._Y()
    kw = {k: v for k, v in W.NUTS.items() if k not in ("seed", "n_chains")}
    seed, n = W.NUTS["seed"], W.NUTS["n_chains"]
    want = nuts_chains(lambda u: fns.log_prob(u, Y), torch.as_tensor(prior_starts(fns, seed, n)),
                       chain_generators(seed, n), **kw)
    ranks = case["ranks"]
    assert ranks[2]["nuts"] is None and ranks[3]["nuts"] is None
    for r in ranks[:2]:
        got = r["nuts"]
        assert got["samples"].shape == (n, W.NUTS["num_samples"], fns.param_set.dim)
        np.testing.assert_allclose(got["samples"], want.samples.numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["logp"], want.logp.numpy(), rtol=1e-12, atol=0)
        np.testing.assert_array_equal(got["num_steps"], want.num_steps.numpy())
        np.testing.assert_array_equal(got["diverging"], want.diverging.numpy())
        np.testing.assert_allclose(got["inv_mass"], want.inv_mass.numpy(), rtol=1e-10)


def test_smc_sharded_matches_unsharded_ladder(case):
    """31 particles padded to 32, likelihoods split over 2 chain ranks and
    summed over 2 trial ranks: the temperature ladder and evidence
    increments of ``smc_run`` on one device."""
    fns, Y = case["port"]._fns(), case["port"]._Y()
    want = smc_run(fns.log_prior_u, lambda u: fns.loglik(fns.param_set.unpack(u), Y),
                   torch.as_tensor(prior_starts(fns, W.SMC["seed"], 32)),
                   stream_generator(W.SMC["seed"], 1),
                   n_mutation_steps=W.SMC["n_mutation_steps"])
    assert want.n_stages >= 2
    for r in case["ranks"]:
        got = r["smc"]
        assert got["particles"].shape == (32, fns.param_set.dim)
        assert got["n_stages"] == want.n_stages
        np.testing.assert_allclose(got["temperatures"], want.temperatures.numpy(), rtol=1e-9)
        np.testing.assert_allclose(got["log_evidence_increments"],
                                   want.log_evidence_increments.numpy(), rtol=1e-9)
        np.testing.assert_allclose(got["particles"], want.particles.numpy(), rtol=1e-9)


def test_advi_sharded_matches_unsharded_trace(case):
    """Over 4 trial ranks (10 trials padded to 12): the same trace on every
    rank, and the trace and mean of the unsharded ``advi_fit`` from the same
    start and draws.  rtol 1e-7: sums over four trial blocks round
    differently from one over all trials, and Adam's normalized steps carry
    that forward (2.2e-9 after 20 steps on this model)."""
    fns, Y = case["port"]._fns(), case["port"]._Y()
    seed = W.ADVI["seed"]
    want = advi_fit(lambda u: fns.log_prob(u, Y), torch.as_tensor(prior_starts(fns, seed, 1)[0]),
                    stream_generator(seed, 1), num_steps=W.ADVI["num_steps"],
                    n_mc=W.ADVI["n_mc"])
    for r in case["ranks"]:
        np.testing.assert_array_equal(r["advi"]["elbo_trace"], case["ranks"][0]["advi"]["elbo_trace"])
        np.testing.assert_allclose(r["advi"]["elbo_trace"], want.elbo_trace.numpy(), rtol=1e-7)
        np.testing.assert_allclose(r["advi"]["mu"], want.mu.numpy(), rtol=1e-7)


def test_sample_posterior_mesh_matches_prior_start_run(case):
    """``sample_posterior(mesh=)`` with its defaults samples from prior
    draws, unwhitened.  At (chain=2, trial=1) its draws are those of
    ``nuts_chains`` on the unsharded ``log_prob`` from ``prior_starts``
    with ``chain_generators``, bit for bit.  At (2, 2) the four ranks run in
    lock-step: the same draws, tree sizes and divergences on every rank.
    (NUTS trajectories separate exponentially, so the trial-sharded draws
    drift from the unsharded ones at the rate the last bits of the
    log-joint differ.)"""
    fns, Y = case["port"]._fns(), case["port"]._Y()
    kw = {k: v for k, v in W.POSTERIOR.items() if k not in ("seed", "n_chains")}
    seed, n = W.POSTERIOR["seed"], W.POSTERIOR["n_chains"]
    want = nuts_chains(lambda u: fns.log_prob(u, Y), torch.as_tensor(prior_starts(fns, seed, n)),
                       chain_generators(seed, n), **kw)
    for r in case["ranks"][:2]:
        got = r["posterior21"]
        np.testing.assert_array_equal(got["samples"], want.samples.numpy())
        np.testing.assert_array_equal(got["num_steps"], want.num_steps.numpy())
    first = case["ranks"][0]["posterior22"]
    for r in case["ranks"]:
        for k in ("samples", "logp", "num_steps", "diverging", "step_size"):
            np.testing.assert_array_equal(r["posterior22"][k], first[k])
    assert first["samples"].shape == want.samples.shape
    assert np.isfinite(first["samples"]).all() and np.isfinite(first["logp"]).all()


def test_sample_posterior_mesh_refusals(case):
    for r in case["ranks"]:
        assert r["refused"] == {k: True for k in W.REFUSED}


def test_ranks_outside_the_mesh_get_none_and_store_nothing(case):
    """``sample_posterior``, ``advi`` and ``smc`` with a mesh of ranks 0 and
    1: results there, None and no stored posterior on ranks 2 and 3."""
    outside = [r["outside"] for r in case["ranks"]]
    assert outside == [[False] * 4, [False] * 4, [True] * 4, [True] * 4]
