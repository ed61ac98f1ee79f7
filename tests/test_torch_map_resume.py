"""PyTorch port, the resumable MAP: ``lbfgs_minimize(state_path=,
max_wall_seconds=, chunk_iters=)`` against the uninterrupted run (bit for
bit) and against the JAX package's ``lbfgs_minimize_chunked`` stopped and
resumed the same way (``test_torch_lbfgs.py``'s tolerances); the
checkpoint's fingerprint; ``fit(options=)`` of both models; pinned
parameters in the restart draws (``fixed=``, the JAX package's
``init_overrides``); and ``GPCSD2D.fit(profile=True)``.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcsd_tpu.infer.lbfgs import LBFGSTimeBudget as JLBFGSTimeBudget
from gpcsd_tpu.infer.lbfgs import lbfgs_minimize_chunked as j_chunked
from gpcsd_tpu.infer.map import sample_restarts as j_sample_restarts
from gpcsd_tpu_torch import paper
from gpcsd_tpu_torch.infer.lbfgs import LBFGSTimeBudget, lbfgs_minimize
from gpcsd_tpu_torch.infer.map import map_fit, sample_restarts
from test_torch_gpcsd2d import port_of_2d, small_jax_2d
from test_torch_lbfgs import PROBLEMS, _models
from torch_port_helpers import jax_small_model, port_of

torch.set_num_threads(2)

RESUMED = ["quadratic_in_a_box", "quadratic_start_outside_the_box",
           "rosenbrock_iteration_limit", "non_finite_start", "short_line_search", "short_history"]


def run_to_completion(call):
    """``call()`` again and again until it stops raising the time budget;
    its result and the number of stops."""
    stops = 0
    while True:
        try:
            return call(), stops
        except (LBFGSTimeBudget, JLBFGSTimeBudget):
            stops += 1


def assert_same_run(a, b):
    for field in ("u", "f", "n_iter", "converged", "failed"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    np.testing.assert_array_equal(a.n_evals, b.n_evals)


@pytest.mark.parametrize("name", RESUMED)
def test_stopped_run_resumes_bit_for_bit_and_matches_jax(name, tmp_path):
    """Stopped at every checkpoint (``max_wall_seconds=0``, ``chunk_iters``
    2) and rerun until done: the uninterrupted run's ``u``, ``f``,
    ``n_iter``, flags and ``n_evals`` to the last bit; and JAX's chunked
    optimizer stopped and resumed the same way to 1e-9."""
    jf, tf, u0s, lo, hi, opts = PROBLEMS[name]
    whole = lbfgs_minimize(tf, torch.as_tensor(u0s), lo=lo, hi=hi, **opts)
    stem = str(tmp_path / "port")
    res, stops = run_to_completion(lambda: lbfgs_minimize(
        tf, torch.as_tensor(u0s), lo=lo, hi=hi, chunk_iters=2, state_path=stem,
        max_wall_seconds=0, **opts))
    assert stops == (int(whole.n_iter.max()) - 1) // 2
    assert_same_run(res, whole)
    assert res.n_syncs == whole.n_syncs
    # a call on the finished checkpoint evaluates nothing more
    again = lbfgs_minimize(tf, torch.as_tensor(u0s), lo=lo, hi=hi, chunk_iters=2,
                           state_path=stem, max_wall_seconds=0, **opts)
    assert_same_run(again, whole)

    want, _ = run_to_completion(lambda: j_chunked(
        jf, jnp.asarray(u0s),
        lo=None if lo is None else jnp.asarray(lo), hi=None if hi is None else jnp.asarray(hi),
        chunk_iters=2, state_path=str(tmp_path / "jax"), max_wall_seconds=0, **opts))
    np.testing.assert_array_equal(res.n_iter.numpy(), np.asarray(want.n_iter))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_array_equal(res.failed.numpy(), np.asarray(want.failed))
    np.testing.assert_allclose(res.u.numpy(), np.asarray(want.u), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(res.f.numpy(), np.asarray(want.f), rtol=1e-9, atol=1e-9)


def test_foreign_or_corrupt_checkpoint_warns_and_starts_fresh(tmp_path):
    _, tf, u0s, lo, hi, opts = PROBLEMS["rosenbrock"]
    stem = str(tmp_path / "state")
    lbfgs_minimize(tf, torch.as_tensor(u0s), state_path=stem, **opts)
    other = torch.as_tensor(u0s[:2] + 0.25)
    fresh = lbfgs_minimize(tf, other, **opts)
    with pytest.warns(UserWarning, match="another run"):
        res = lbfgs_minimize(tf, other, state_path=stem, **opts)
    assert_same_run(res, fresh)
    # the fresh run overwrote the checkpoint: the same call now resumes quietly
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert_same_run(lbfgs_minimize(tf, other, state_path=stem, **opts), fresh)
    with open(stem + ".npz", "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.warns(UserWarning, match="could not resume"):
        assert_same_run(lbfgs_minimize(tf, other, state_path=stem, **opts), fresh)


def test_budget_needs_a_state_path_and_the_torch_backend(tmp_path):
    _, tf, u0s, _, _, _ = PROBLEMS["rosenbrock"]
    with pytest.raises(ValueError, match="requires state_path"):
        lbfgs_minimize(tf, torch.as_tensor(u0s), max_wall_seconds=10.0)
    with pytest.raises(ValueError, match="chunk_iters"):
        lbfgs_minimize(tf, torch.as_tensor(u0s), chunk_iters=0)
    _, tm = _models("1d")
    fns = tm._fns()
    u0s = sample_restarts(fns.param_set, np.random.default_rng(0), 2)
    with pytest.raises(ValueError, match="backend='torch'"):
        map_fit(fns.neg_log_joint, fns.param_set, tm._Y(), u0s, backend="scipy",
                state_path=str(tmp_path / "s"))


def test_row_data_enters_the_fingerprint(tmp_path):
    """Two runs from the same starts on different per-row data: the second
    does not resume from the first's checkpoint."""
    def fun(u, c):
        return torch.sum(torch.square(u - c) * torch.arange(1.0, 4.0, dtype=u.dtype), dim=-1)

    u0s = torch.zeros(2, 3, dtype=torch.float64)
    c1 = torch.ones(2, 3, dtype=torch.float64)
    c2 = torch.full((2, 3), -2.0, dtype=torch.float64)
    stem = str(tmp_path / "rows")
    first = lbfgs_minimize(fun, u0s, row_data=c1, state_path=stem)
    assert np.allclose(first.u.numpy(), 1.0)
    with pytest.warns(UserWarning, match="another run"):
        second = lbfgs_minimize(fun, u0s, row_data=c2, state_path=stem)
    assert_same_run(second, lbfgs_minimize(fun, u0s, row_data=c2))
    assert np.allclose(second.u.numpy(), -2.0)


def _fit_models():
    jm = jax_small_model(seed=3, nx=6, nt=10, ntrials=2)
    return {"1d": (lambda: port_of(jm), 12),
            "2d": (lambda: paper.neuropixels_problem(0, nt=20, ntrials=3, ngl1=8, ngl2=12,
                                                     device="cpu"), 20)}


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_fit_options_stop_and_resume(kind, tmp_path):
    """``fit(options={"state_path", "max_wall_seconds": 0, "chunk_iters": 2})``
    raises the time budget, and rerun until done ends where ``fit`` without
    those keys ends, bit for bit."""
    make, maxiter = _fit_models()[kind]
    uninterrupted = make()
    whole = uninterrupted.fit(n_restarts=3, seed=1, options={"maxiter": maxiter})
    model = make()
    opts = {"maxiter": maxiter, "chunk_iters": 2, "max_wall_seconds": 0,
            "state_path": str(tmp_path / "map_state")}
    with pytest.raises(LBFGSTimeBudget):
        model.fit(n_restarts=3, seed=1, options=opts)
    res, stops = run_to_completion(lambda: model.fit(n_restarts=3, seed=1, options=opts))
    assert stops >= 1 and os.path.exists(opts["state_path"] + ".npz")
    np.testing.assert_array_equal(res.u_all, whole.u_all)
    np.testing.assert_array_equal(res.nll_values, whole.nll_values)
    np.testing.assert_array_equal(res.n_evals, whole.n_evals)
    assert res.messages == whole.messages
    want = uninterrupted.extract_model_params()
    for k, v in model.extract_model_params().items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]), err_msg=k)


# ---------------------------------------------------------- pinned restarts

PINNED = {"R": 150.0, "sig2n": np.linspace(0.02, 0.07, 6)}


def test_param_sample_fixed_consumes_its_draws():
    """Pinned names hold their values; every other name gets what the
    unpinned draw from the same seed gives it."""
    ps = port_of(jax_small_model(per_channel=True))._fns().param_set
    free = ps.sample(np.random.default_rng(4))
    pinned = ps.sample(np.random.default_rng(4), fixed=PINNED)
    assert set(pinned) == set(free) == set(ps.names)
    for name in ps.names:
        np.testing.assert_array_equal(pinned[name], PINNED[name] if name in PINNED else free[name])


def test_sample_restarts_fixed_matches_jax_on_the_pinned_columns():
    jm = jax_small_model(per_channel=True)
    ps = port_of(jm)._fns().param_set
    free = sample_restarts(ps, np.random.default_rng(7), 4)
    pinned = sample_restarts(ps, np.random.default_rng(7), 4, fixed=PINNED)
    want = np.asarray(j_sample_restarts(jm._fns().param_set, jax.random.PRNGKey(7), 4,
                                        fixed={k: jnp.asarray(v) for k, v in PINNED.items()}))
    cols = np.zeros(ps.dim, dtype=bool)
    for name in PINNED:
        lo, hi = ps._offsets[name]
        cols[lo:hi] = True
    assert cols.sum() == 7
    np.testing.assert_allclose(pinned[:, cols], want[:, cols], rtol=1e-15, atol=1e-15)
    np.testing.assert_array_equal(pinned[:, ~cols], free[:, ~cols])
    assert not np.array_equal(pinned[:, cols], free[:, cols])


# --------------------------------------------------------- fit(profile=True)

def test_gpcsd2d_fit_profile_writes_stats_like_jax(tmp_path, monkeypatch):
    """Both packages' ``fit(profile=True)`` write ``objfunstats`` and
    ``gradobjfunstats`` into the working directory, return None and leave
    the parameters as they were."""
    import pstats

    jm = small_jax_2d(seed=3, nt=8, ntrials=2)
    tm = port_of_2d(jm)
    for label, model in (("port", tm), ("jax", jm)):
        workdir = tmp_path / label
        workdir.mkdir()
        monkeypatch.chdir(workdir)
        before = model.extract_model_params()
        assert model.fit(profile=True, seed=2) is None
        after = model.extract_model_params()
        assert before.keys() == after.keys()
        for k in before:
            np.testing.assert_array_equal(np.asarray(after[k]), np.asarray(before[k]), err_msg=k)
        assert sorted(os.listdir(workdir)) == ["gradobjfunstats", "objfunstats"]
        for name in ("objfunstats", "gradobjfunstats"):
            assert pstats.Stats(str(workdir / name)).total_calls > 0
    assert not hasattr(tm, "fit_result")
