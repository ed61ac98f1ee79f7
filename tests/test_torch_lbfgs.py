"""PyTorch port, the batched MAP engine: ``infer.lbfgs.lbfgs_minimize``
against ``gpcsd_tpu.infer.lbfgs.lbfgs_minimize`` on analytic objectives
written once for each package, and ``map_fit(backend="torch")`` against
``map_fit(backend="jax")`` from the same starting points on a small 1D and
a small 2D model.

On the analytic objectives both optimizers do the same float64 arithmetic
in the same order up to the rounding of their dot products, so they are held
to equal iteration counts and flags and to 1e-9 on ``u`` and ``f``.  On the
models the two packages' gradients differ by ~1e-9 (two eigensolvers), which
a trajectory amplifies: there the first iterations and the final NLL are
compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpcsd_tpu as g
from gpcsd_tpu.infer.lbfgs import lbfgs_minimize as j_lbfgs
from gpcsd_tpu.infer.map import map_fit as j_map_fit
from gpcsd_tpu.infer.map import sample_restarts as j_sample_restarts
from gpcsd_tpu_torch.infer import lbfgs as t_lbfgs_mod
from gpcsd_tpu_torch.infer.lbfgs import lbfgs_minimize as t_lbfgs
from gpcsd_tpu_torch.infer.map import map_fit as t_map_fit
from test_torch_gpcsd1d import port_of, small_jax_model
from test_torch_gpcsd2d import port_of_2d, small_jax_2d

torch.set_num_threads(2)

DIM = 6
_RNG = np.random.default_rng(11)
CURV = np.logspace(0, 4, DIM)  # condition number 1e4
CENTRE = _RNG.normal(size=DIM)
MIX = 0.3 * _RNG.normal(size=(DIM, DIM))
HESS = MIX.T @ np.diag(CURV) @ MIX + np.diag(CURV)


def quad_j(u):
    d = u - CENTRE
    return 0.5 * jnp.sum(d * (jnp.asarray(HESS) @ d))


def quad_t(u):
    # the product with HESS written out as a sum over the last axis: a BLAS
    # call would round a row differently in batches of different size
    d = u - torch.as_tensor(CENTRE)
    return 0.5 * torch.sum(d * torch.sum(torch.as_tensor(HESS) * d[..., None, :], dim=-1), dim=-1)


def rosen_j(u):
    return jnp.sum(100.0 * (u[1:] - u[:-1] ** 2) ** 2 + (1.0 - u[:-1]) ** 2)


def rosen_t(u):
    return torch.sum(100.0 * (u[..., 1:] - u[..., :-1] ** 2) ** 2 + (1.0 - u[..., :-1]) ** 2, dim=-1)


def logbarrier_j(u):
    # non-finite for u[0] <= 0
    return jnp.sum(u * u) - jnp.log(u[0]) + jnp.sqrt(u[1])


def logbarrier_t(u):
    return torch.sum(u * u, dim=-1) - torch.log(u[..., 0]) + torch.sqrt(u[..., 1])


BOX = (np.array([-0.5, -2.0, -0.2, -2.0, -2.0, 0.1]), np.array([2.0, 2.0, 0.3, 2.0, 0.05, 2.0]))

#: name -> (jax objective, torch objective, starts (C, dim), lo, hi, options)
PROBLEMS = {
    "quadratic_in_a_box": (quad_j, quad_t, _RNG.uniform(-0.4, 0.3, size=(3, DIM)) + 0.2, *BOX, {}),
    "quadratic_unconstrained": (quad_j, quad_t, _RNG.normal(size=(2, DIM)), None, None, {}),
    "quadratic_start_outside_the_box": (
        quad_j, quad_t, np.array([[5.0, -7.0, 3.0, 0.0, 4.0, -3.0], [-4.0, 9.0, -1.0, 6.0, 0.5, 8.0]]),
        *BOX, {}),
    "rosenbrock": (rosen_j, rosen_t, np.array([[-1.2, 1.0], [0.5, -0.5], [2.0, 2.0]]), None, None,
                   {"max_iter": 200}),
    "rosenbrock_in_a_box": (rosen_j, rosen_t, np.array([[-1.2, 1.0], [0.0, 0.0]]),
                            np.array([-1.5, -0.5]), np.array([0.8, 2.0]), {"max_iter": 200}),
    "rosenbrock_iteration_limit": (rosen_j, rosen_t, np.array([[-1.2, 1.0]]), None, None,
                                   {"max_iter": 7}),
    "non_finite_start": (logbarrier_j, logbarrier_t,
                         np.array([[-1.0, 1.0, 0.3], [0.7, 0.2, -0.3], [0.5, -0.1, 0.1]]),
                         None, None, {}),
    "non_finite_region_in_the_search": (
        logbarrier_j, logbarrier_t, np.array([[0.01, 0.5, 2.0], [1.5, 1e-4, -1.0]]), None, None, {}),
    "short_line_search": (rosen_j, rosen_t, np.array([[-1.2, 1.0], [3.0, -3.0]]), None, None,
                          {"max_linesearch": 2, "max_iter": 60}),
    "short_history": (quad_j, quad_t, _RNG.normal(size=(2, DIM)), *BOX, {"history": 3}),
}


def run_jax(fun, u0, lo, hi, opts):
    return j_lbfgs(fun, jnp.asarray(u0), lo=None if lo is None else jnp.asarray(lo),
                   hi=None if hi is None else jnp.asarray(hi), **opts)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_matches_jax_on_analytic_objectives(name):
    """``n_iter``, ``converged`` and ``failed`` equal; ``u`` and ``f`` to 1e-9
    (relative to max(|.|, 1)); every start in one batched run."""
    jf, tf, u0s, lo, hi, opts = PROBLEMS[name]
    res = t_lbfgs(tf, torch.as_tensor(u0s), lo=lo, hi=hi, **opts)
    assert res.u.shape == u0s.shape and res.f.shape == (len(u0s),)
    for i, u0 in enumerate(u0s):
        want = run_jax(jf, u0, lo, hi, opts)
        assert int(res.n_iter[i]) == int(want.n_iter), (i, int(res.n_iter[i]), int(want.n_iter))
        assert bool(res.converged[i]) == bool(want.converged)
        assert bool(res.failed[i]) == bool(want.failed)
        np.testing.assert_allclose(res.u[i].numpy(), np.asarray(want.u), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(float(res.f[i]), float(want.f), rtol=1e-9, atol=1e-9)
    if lo is not None:
        assert bool(torch.all(res.u >= torch.as_tensor(lo)) and torch.all(res.u <= torch.as_tensor(hi)))


def test_problems_cover_the_branches():
    """The problems above reach what they are named for."""
    res = {k: t_lbfgs(v[1], torch.as_tensor(v[2]), lo=v[3], hi=v[4], **v[5])
           for k, v in PROBLEMS.items()}
    assert res["non_finite_start"].failed.tolist() == [True, False, True]
    assert res["non_finite_start"].n_iter.tolist()[0] == 0
    assert res["non_finite_start"].f[0].item() == torch.finfo(torch.float64).max
    assert float(res["quadratic_unconstrained"].f.max()) < 1e-10  # stops on the f-stall test
    assert res["rosenbrock"].converged.any() and float(res["rosenbrock"].f.max()) < 1e-10
    assert res["rosenbrock_iteration_limit"].n_iter.tolist() == [7]
    assert not res["rosenbrock_iteration_limit"].converged.any()
    box = res["quadratic_in_a_box"].u
    assert bool((box[:, 2] == 0.3).any())  # an active bound


def test_batch_equals_single_runs_bit_for_bit():
    """A row's iterates do not depend on which rows run beside it: a batch
    of 5 starts equals the 5 run singly, to the last bit."""
    rng = np.random.default_rng(3)
    for tf, u0s, lo, hi in (
        (quad_t, rng.normal(size=(5, DIM)), *BOX),
        (rosen_t, rng.uniform(-2.0, 2.0, size=(5, 2)), None, None),
        (logbarrier_t, rng.uniform(-0.2, 1.5, size=(5, 3)), None, None),
    ):
        batch = t_lbfgs(tf, torch.as_tensor(u0s), lo=lo, hi=hi, max_iter=60)
        assert len(set(batch.n_iter.tolist())) > 1  # rows finish at different iterations
        for i in range(5):
            one = t_lbfgs(tf, torch.as_tensor(u0s[i]), lo=lo, hi=hi, max_iter=60)
            assert torch.equal(one.u[0], batch.u[i]) and torch.equal(one.f[0], batch.f[i])
            assert int(one.n_iter[0]) == int(batch.n_iter[i])
            assert bool(one.converged[0]) == bool(batch.converged[i])
            assert bool(one.failed[0]) == bool(batch.failed[i])
            assert one.n_evals[0] == batch.n_evals[i]


def test_only_live_rows_are_evaluated():
    """Finished rows and rows whose search has succeeded are not evaluated
    again: the rows the objective sees add up to ``n_evals``, and the host
    reads the device once per iteration and once per line-search pass."""
    seen = []

    def counted(u):
        seen.append(u.shape[0])
        return rosen_t(u)

    u0s = np.array([[-1.2, 1.0], [1.0, 1.0], [0.9, 0.8], [3.0, -3.0]])
    res = t_lbfgs(counted, torch.as_tensor(u0s), max_iter=100)
    assert sum(seen) == int(res.n_evals.sum())
    assert seen[0] == 4 and min(seen) == 1
    assert res.n_evals[1] == 2 and int(res.n_iter[1]) == 1  # starts at the optimum
    # one read per loop test (the last finds no live row) and one per pass
    assert res.n_syncs == (int(res.n_iter.max()) + 1) + (len(seen) - 1)


def test_two_loop_matches_jax():
    """The batched two-loop recursion against the JAX one, row by row, with
    part-filled circular histories: 1e-13."""
    from gpcsd_tpu.infer.lbfgs import _two_loop as j_two_loop

    rng = np.random.default_rng(4)
    L, m, dim = 3, 4, 5
    gvec, s, y = rng.normal(size=(L, dim)), rng.normal(size=(L, m, dim)), rng.normal(size=(L, m, dim))
    k = np.array([0, 2, 9])
    rho = np.zeros((L, m))
    for row, kk in enumerate(k):
        for it in range(max(kk - m, 0), kk):
            rho[row, it % m] = 1.0 / abs(np.dot(s[row, it % m], y[row, it % m]))
    got = t_lbfgs_mod._two_loop(*(torch.as_tensor(a) for a in (gvec, s, y, rho, k)), m)
    for row in range(L):
        want = j_two_loop(*(jnp.asarray(a[row]) for a in (gvec, s, y, rho)), jnp.asarray(k[row]), m)
        np.testing.assert_allclose(got[row].numpy(), np.asarray(want), rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(got[0].numpy(), gvec[0])  # empty history: gamma = 1


# ------------------------------------------------------------- on the models

def _models(kind):
    if kind == "1d":
        jm = small_jax_model(seed=3, nx=6, nt=10, ntrials=2)
        return jm, port_of(jm)
    jm = small_jax_2d(seed=3, nt=8, ntrials=2)
    return jm, port_of_2d(jm)


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_map_fit_torch_matches_jax_backend(kind):
    """``map_fit(backend="torch")`` against ``map_fit(backend="jax")`` from
    the same ``u0s``: final NLL of every restart to 1e-6 relative, the same
    best restart, messages in the same form."""
    jm, tm = _models(kind)
    jfns, tfns = jm._fns(), tm._fns()
    key = jax.random.PRNGKey(2)
    u0s = np.asarray(j_sample_restarts(jfns.param_set, key, 3))
    jres = j_map_fit(jfns.neg_log_joint, jfns.param_set, jm._Y(), key, n_restarts=3,
                     backend="jax", maxiter=40)
    tres = t_map_fit(tfns.neg_log_joint, tfns.param_set, tm._Y(), u0s, backend="torch", maxiter=40)
    np.testing.assert_allclose(tres.nll_values, jres.nll_values, rtol=1e-6)
    assert int(np.argmin(tres.nll_values)) == int(np.argmin(jres.nll_values))
    assert tres.nll_best == pytest.approx(jres.nll_best, rel=1e-6)
    assert all(msg.startswith("converged=") and " iters=" in msg for msg in tres.messages)
    assert tres.n_evals.shape == (3,) and tres.n_syncs > 0
    lo, hi = tfns.param_set.bounds()
    assert np.all(tres.u_all >= lo) and np.all(tres.u_all <= hi)


def test_first_iterations_on_the_model_match_jax():
    """Three iterations on the small 1D model from the same start: the same
    iteration count, ``u`` to 1e-6 and ``f`` to 1e-9 relative (the gradients
    of the two packages agree to ~1e-9 here)."""
    jm, tm = _models("1d")
    jfns, tfns = jm._fns(), tm._fns()
    u0 = np.asarray(j_sample_restarts(jfns.param_set, jax.random.PRNGKey(2), 1))[0]
    lo, hi = tfns.param_set.bounds()
    want = jax.jit(lambda u: j_lbfgs(lambda v: jfns.neg_log_joint(v, jm._Y()), u,
                                     lo=jnp.asarray(lo), hi=jnp.asarray(hi), max_iter=3))(jnp.asarray(u0))
    got = t_lbfgs(lambda u: tfns.neg_log_joint(u, tm._Y()), torch.as_tensor(u0), lo=lo, hi=hi,
                  max_iter=3)
    assert int(got.n_iter[0]) == int(want.n_iter) == 3
    np.testing.assert_allclose(got.u[0].numpy(), np.asarray(want.u), atol=1e-6)
    assert float(got.f[0]) == pytest.approx(float(want.f), rel=1e-9)


def test_map_fit_marks_failed_restarts_and_rejects_unknown_backend():
    """A restart whose objective is not finite at its start gets NLL inf and
    cannot win; all failed raises, as in the JAX package."""
    _, tm = _models("1d")
    fns = tm._fns()
    u0s = np.stack([fns.param_set.pack(tm._theta()).numpy()] * 2)

    def objective(u, Y):
        bad = u[..., 0] > u0s[0, 0] + 0.5
        return torch.where(bad, torch.nan, fns.neg_log_joint(u, Y))

    u0s[1, 0] += 0.6
    res = t_map_fit(objective, fns.param_set, tm._Y(), u0s, maxiter=3)
    assert np.isinf(res.nll_values[1]) and np.isfinite(res.nll_values[0])
    assert res.nll_best == res.nll_values[0]
    with pytest.raises(RuntimeError, match="all restarts failed"):
        t_map_fit(objective, fns.param_set, tm._Y(), u0s[1:], maxiter=3)
    with pytest.raises(ValueError, match="backend"):
        t_map_fit(fns.neg_log_joint, fns.param_set, tm._Y(), u0s, backend="jax")


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("backend", ["torch", "scipy"])
def test_fit_backends(kind, backend):
    """``fit`` on both models with either backend: every restart ends no
    higher than it started, the best is written back; ``torch`` is the
    default backend."""
    import inspect

    from gpcsd_tpu_torch.infer.map import sample_restarts

    _, tm = _models(kind)
    assert inspect.signature(tm.fit).parameters["backend"].default == "torch"
    fns, Y = tm._fns(), tm._Y()
    res = tm.fit(n_restarts=2, seed=1, backend=backend, options={"maxiter": 6})
    u0s = torch.as_tensor(sample_restarts(fns.param_set, np.random.default_rng(1), 2))
    nll0 = fns.neg_log_joint(u0s, Y).detach().numpy()
    assert np.all(np.isfinite(res.nll_values)) and np.all(res.nll_values <= nll0)
    np.testing.assert_allclose(fns.param_set.pack(tm._theta()).numpy(), res.u_best, rtol=1e-12)
    assert tm.fit_result is res
    assert (res.n_evals is None) == (backend == "scipy")


def test_fit_fix_R_keeps_R():
    _, tm = _models("2d")
    R0 = tm.R["value"]
    res = tm.fit(n_restarts=1, fix_R=True, options={"maxiter": 3})
    assert tm.R["value"] == R0 and res.u_best.shape == (7,)
