"""PyTorch port, ``models/torus_graph``: every function against the JAX
package's on the same numpy phases, CPU float64, on the JAX tests' Gibbs
cases (the phase-difference model at d = 5, n = 3000; the full model at
d = 4) and at the auditory size d = 48.

Every field is held to 1e-9 of its largest magnitude (the readings are
~1e-15 at the Gibbs cases: the same closed form, another summation order).
``gibbs_sample`` is numpy in both packages and must give the same bits.
"""

import jax
import numpy as np
import pytest
import torch

from gpcsd_tpu.models import torus_graph as J
from gpcsd_tpu_torch.models import torus_graph as T

TOL = 1e-9
FIELDS = ("phi", "phi_cov", "pvals", "kappa", "cond_coupling")


def true_phi(d, kappa, edges, sel_mode=(False, True, False)):
    lay = J.layout(d, sel_mode)
    phi = np.zeros(lay.m)
    pairs = [tuple(p) for p in lay.pairs.tolist()]
    for e in edges:
        phi[lay.diff_off + pairs.index(tuple(sorted(e)))] = kappa
    return phi


def max_rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) / max(np.max(np.abs(want)), 1e-300))


@pytest.fixture(scope="module")
def gibbs5():
    return J.gibbs_sample(true_phi(5, 1.2, ((0, 1), (1, 2), (3, 4))), 5, 3000, seed=1)


@pytest.fixture(scope="module")
def gibbs4():
    return J.gibbs_sample(true_phi(4, 1.0, ((0, 1),)), 4, 1500, seed=2)


@pytest.mark.parametrize("case", [
    (5, 3000, 1, ((0, 1), (1, 2), (3, 4)), 1.2), (4, 300, 3, ((0, 1),), 0.4),
])
def test_gibbs_sample_same_bits(case):
    d, n, seed, edges, kappa = case
    phi = true_phi(d, kappa, edges)
    assert np.array_equal(T.gibbs_sample(phi, d, n, seed=seed), J.gibbs_sample(phi, d, n, seed=seed))


def test_gibbs_sample_full_model_same_bits():
    phi = np.random.default_rng(0).normal(scale=0.3, size=J.layout(4, (True, True, True)).m)
    got = T.gibbs_sample(phi, 4, 200, seed=5, sel_mode=(True, True, True))
    assert np.array_equal(got, J.gibbs_sample(phi, 4, 200, seed=5, sel_mode=(True, True, True)))


@pytest.mark.parametrize("d", [4, 6, 48])
@pytest.mark.parametrize("sel_mode", [(False, True, False), (True, True, True), (True, False, True)])
def test_layout(d, sel_mode):
    lt, lj = T.layout(d, sel_mode), J.layout(d, sel_mode)
    assert np.array_equal(lt.pairs, lj.pairs)
    assert (lt.m, lt.marg_off, lt.diff_off, lt.sum_off) == (lj.m, lj.marg_off, lj.diff_off, lj.sum_off)


@pytest.mark.parametrize("sel_mode", [(False, True, False), (True, True, True), (False, False, True)])
def test_statistics_gamma_score(gibbs5, sel_mode):
    X = gibbs5[:, :400]
    lt, lj = T.layout(5, sel_mode), J.layout(5, sel_mode)
    Xt = torch.tensor(X)
    assert max_rel(T.suff_stats(lt, Xt), J.suff_stats(lj, X)) <= TOL
    assert max_rel(T.gamma_matrix(lt, Xt), J.gamma_matrix(lj, X)) <= TOL
    phi = np.random.default_rng(3).normal(size=lt.m)
    assert max_rel(T.score_vector(lt, Xt, torch.tensor(phi)), J.score_vector(lj, X, phi)) <= TOL
    # a leading batch axis: each slice equals its own call
    Xb = torch.stack([Xt, Xt.flip(-1)])
    G = T.gamma_matrix(lt, Xb)
    assert torch.equal(G[1], T.gamma_matrix(lt, Xt.flip(-1)))


def assert_fit_matches(X, sel_mode):
    rt = T.torus_graph_fit(X, sel_mode=sel_mode, device="cpu")
    rj = J.torus_graph_fit(X, sel_mode=sel_mode)
    for f in FIELDS:
        assert max_rel(getattr(rt, f), getattr(rj, f)) <= TOL, f
    assert np.array_equal(rt.graph.numpy(), np.asarray(rj.graph))
    assert np.array_equal(rt.pairs, rj.pairs)
    return rt


def test_fit_recovers_edges_as_jax(gibbs5):
    rt = assert_fit_matches(gibbs5, (False, True, False))
    pairs = [tuple(p) for p in rt.pairs.tolist()]
    pv = rt.pvals.numpy()
    for e in ((0, 1), (1, 2), (3, 4)):
        assert pv[pairs.index(e)] < 1e-4


def test_fit_full_model(gibbs4):
    rt = assert_fit_matches(gibbs4, (True, True, True))
    pairs = [tuple(p) for p in rt.pairs.tolist()]
    assert pairs[int(torch.argmax(rt.kappa))] == (0, 1)


def test_fit_auditory_size():
    """d = 48 (two stacked probes), n = 60 trials: m = 2256 parameters from
    60 samples, held up by the ridge only.  Port and JAX on the same CPU
    agree to ~1e-14 here; the card is another matter (chip_smoke.py)."""
    X = np.random.default_rng(7).uniform(-np.pi, np.pi, size=(48, 60))
    rt = T.torus_graph_fit(X, device="cpu")
    rj = J.torus_graph_fit(X)
    for f in ("phi", "kappa", "cond_coupling"):
        assert max_rel(getattr(rt, f), getattr(rj, f)) <= TOL, f


def test_pytg_shim_structure():
    X = np.random.default_rng(42).uniform(0, 2 * np.pi, size=(6, 300))
    got = T.torusGraphs(X, selMode=(False, True, False), device="cpu")
    want = J.torusGraphs(X, selMode=(False, True, False))
    graph, _, _, nodepairs, _, phi, phi_cov = got
    assert nodepairs["pVals"].shape == (15,) and nodepairs["condCoupling"].shape == (15,)
    assert phi.shape == (30,) and phi_cov.shape == (30, 30) and graph.shape == (15,)
    assert all(isinstance(a, np.ndarray) for a in (graph, phi, phi_cov, nodepairs["kappa"]))
    assert [a is None for a in got] == [a is None for a in want]
    for k in ("pVals", "condCoupling", "kappa"):
        assert max_rel(nodepairs[k], want[3][k]) <= TOL
    assert np.array_equal(nodepairs["pairs"], want[3]["pairs"])


def jax_indices(key, nboot, n):
    """The trial indices JAX's bootstrap draws for ``key``."""
    keys = jax.random.split(key, nboot)
    return np.stack([np.asarray(jax.random.choice(k, n, (n,), replace=True)) for k in keys])


@pytest.mark.parametrize("batch_size", [4, 3])
def test_bootstrap_on_jax_indices(gibbs4, batch_size):
    X = gibbs4[:, :600]
    key = jax.random.PRNGKey(0)
    want = J.bootstrap_partial_plv(X, 8, key, batch_size=4)
    got = T.bootstrap_partial_plv(X, 8, indices=jax_indices(key, 8, 600),
                                  batch_size=batch_size, device="cpu")
    assert got.shape == (6, 8)
    assert max_rel(got, want) <= TOL


def test_bootstrap_replicate_is_the_fit_on_its_trials():
    X = np.random.default_rng(8).uniform(-np.pi, np.pi, size=(12, 40))
    gen = torch.Generator().manual_seed(3)
    bs = T.bootstrap_partial_plv(X, 5, generator=gen, batch_size=2, device="cpu")
    idx = torch.randint(0, 40, (5, 40), generator=torch.Generator().manual_seed(3)).numpy()
    for r in (0, 1, 4):
        want = T.torus_graph_fit(X[:, idx[r]], device="cpu").cond_coupling
        assert max_rel(bs[:, r], want) <= TOL
    assert bs.std(dim=1).max() > 0
    with pytest.raises(ValueError):
        T.bootstrap_partial_plv(X, 5, indices=idx[:, :10], device="cpu")


def test_needs_pairwise_terms():
    with pytest.raises(ValueError):
        T.torus_graph_fit(np.zeros((3, 10)), sel_mode=(True, False, False), device="cpu")
