"""PyTorch port, ``models/shifts`` and the ``row_data`` argument of the
batched L-BFGS: against the JAX package on the same numpy inputs, CPU
float64.

- ``shift_component`` follows ``jnp.interp``: value and ``jax.grad`` with
  respect to tau at tau = 0 (every t + tau a knot: the right-hand slope),
  at interior knots, between knots and beyond both edges (held value,
  gradient 0), to 1e-12.
- ``shift_nll`` to 1e-12 relative; ``estimate_shifts`` on the JAX model's
  own factors: tau to 1e-6 absolute (ms; the readings are ~1e-11),
  ``converged`` equal.
- ``lbfgs_minimize(row_data=...)``: with ``row_data=None`` the results are
  those of a call without the argument, bit for bit; with it, each row of
  a batched run equals that row run alone, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpcsd_tpu as g
from gpcsd_tpu.models import shifts as J
from gpcsd_tpu.ops.forward import fwd_model_1d as j_fwd
from gpcsd_tpu_torch.infer.lbfgs import lbfgs_minimize
from gpcsd_tpu_torch.models import shifts as T
from gpcsd_tpu_torch.ops.kronlik import KronFactors
from torch_port_helpers import jax_small_model, port_of

NT = 40
T_GRID = np.linspace(0.0, 60.0, NT)
STEP = T_GRID[1] - T_GRID[0]


def t_value_grad(mu, w, tau):
    tt = torch.tensor(tau, dtype=torch.float64, requires_grad=True)
    v = torch.sum(torch.tensor(w) * T.shift_component(torch.tensor(mu), torch.tensor(T_GRID), tt))
    (gr,) = torch.autograd.grad(v, tt)
    return float(v.detach()), float(gr)


@pytest.mark.parametrize("tau", [0.0, 3 * STEP, -7 * STEP, 0.4 * STEP, 2.3, -5.7,
                                 59.0, 60.0, 61.5, -60.0, -75.0, 1e-13])
def test_shift_component_value_and_grad(tau):
    rng = np.random.default_rng(0)
    mu, w = rng.normal(size=(5, NT)), rng.normal(size=(5, NT))
    f = lambda s: jnp.sum(jnp.asarray(w) * J.shift_component(jnp.asarray(mu), T_GRID, s))  # noqa: E731
    vj, gj = jax.value_and_grad(f)(tau)
    vt, gt = t_value_grad(mu, w, tau)
    assert abs(vt - float(vj)) <= 1e-12 * np.abs(w).sum() * np.abs(mu).max()
    assert abs(gt - float(gj)) <= 1e-12 * max(abs(float(gj)), 1.0)
    if abs(tau) > 60.0:
        assert gt == 0.0


def test_shift_component_batched_rows():
    mu = np.random.default_rng(1).normal(size=(3, NT))
    taus = torch.tensor([0.0, 2.5, -70.0, 7 * STEP], dtype=torch.float64)
    out = T.shift_component(torch.tensor(mu), torch.tensor(T_GRID), taus)
    assert out.shape == (4, 3, NT)
    for k in range(4):
        assert torch.equal(out[k], T.shift_component(torch.tensor(mu), torch.tensor(T_GRID), taus[k]))
    assert torch.allclose(out[0], torch.tensor(mu), rtol=0, atol=1e-14)  # the last knot: fp[-2] + df


@pytest.fixture(scope="module")
def shift_problem():
    """The JAX test's recovery case at a small size: one dipole component
    shifted per trial, noise parameters set by hand, the JAX model's
    factors and their copy as tensors."""
    rng = np.random.default_rng(42)
    nx, ntrials = 24, 10
    x = np.linspace(0, 2300, nx)
    z = np.linspace(0, 2300, 93)
    zc, tc = z.reshape(-1, 1), T_GRID.reshape(1, -1)
    comp = (np.exp(-((zc - 600) ** 2) / (2 * 180**2)) - np.exp(-((zc - 1100) ** 2) / (2 * 180**2))) \
        * np.exp(-((tc - 25) ** 2) / (2 * 4**2))
    comp_lfp = np.array(j_fwd(comp, z, x, 150.0))
    comp_lfp /= np.max(np.abs(comp_lfp))
    tau_true = 3.0 * rng.standard_normal(ntrials)
    lfp = np.stack([np.array([np.interp(T_GRID + tau_true[tr], T_GRID, comp_lfp[ch]) for ch in range(nx)])
                    for tr in range(ntrials)], axis=2)
    lfp += 0.02 * rng.standard_normal(lfp.shape)
    m = g.GPCSD1D(lfp - lfp.mean(2, keepdims=True), x.reshape(-1, 1), T_GRID.reshape(-1, 1), ngl=40)
    m.R["value"], m.spatial_cov.params["ell"]["value"] = 150.0, 300.0
    for tc_, (ell, s2) in zip(m.temporal_cov_list, ((8.0, 0.05), (2.0, 0.02))):
        tc_.params["ell"]["value"], tc_.params["sigma2"]["value"] = ell, s2
    m.sig2n["value"] = 4e-4
    jf = m._fns().build_factors(m._theta())
    tf = KronFactors(*(torch.tensor(np.asarray(f)) for f in jf))
    return dict(lfp=lfp, mu_c=comp_lfp[None], mu_b=np.zeros((nx, NT)), jf=jf, tf=tf, tau_true=tau_true)


def test_shift_nll_matches_jax(shift_problem):
    p = shift_problem
    for tau in (np.array([0.0]), np.array([1.7]), np.array([-64.0])):
        for tr in (0, 3):
            want = float(J.shift_nll(jnp.asarray(tau), p["lfp"][:, :, tr], p["mu_b"], p["mu_c"],
                                     T_GRID, p["jf"], 0.5, 4.0))
            got = float(T.shift_nll(torch.tensor(tau), torch.tensor(p["lfp"][:, :, tr]),
                                    torch.tensor(p["mu_b"]), torch.tensor(p["mu_c"]),
                                    torch.tensor(T_GRID), p["tf"], 0.5, 4.0))
            assert abs(got - want) <= 1e-12 * abs(want)
    # batched rows: (B, n_seg) with (B, nx, nt) gives each row's own value
    taus = torch.tensor([[0.0], [1.7], [-3.0]])
    lfps = torch.tensor(np.moveaxis(p["lfp"][:, :, :3], 2, 0))
    got = T.shift_nll(taus, lfps, torch.tensor(p["mu_b"]), torch.tensor(p["mu_c"]),
                      torch.tensor(T_GRID), p["tf"])
    for b in range(3):
        assert got[b] == T.shift_nll(taus[b], lfps[b], torch.tensor(p["mu_b"]), torch.tensor(p["mu_c"]),
                                     torch.tensor(T_GRID), p["tf"])


def test_estimate_shifts_matches_jax(shift_problem):
    p = shift_problem
    rj = J.estimate_shifts(p["lfp"], p["mu_b"], p["mu_c"], T_GRID, p["jf"], maxiter=50)
    rt = T.estimate_shifts(p["lfp"], p["mu_b"], p["mu_c"], T_GRID, p["tf"], maxiter=50, device="cpu")
    assert rt.tau.shape == (10, 1) and isinstance(rt.tau, np.ndarray)
    assert np.max(np.abs(rt.tau - rj.tau)) <= 1e-6
    assert np.max(np.abs(rt.nll - rj.nll) / np.abs(rj.nll)) <= 1e-9
    assert np.array_equal(rt.converged, rj.converged)
    assert np.all(rt.n_evals >= 2)


def test_estimate_shifts_on_port_factors(shift_problem):
    """Through the port's own model (``port_of``): the same factors up to
    the two eigensolvers, the same shifts."""
    p = shift_problem
    jm = jax_small_model(nx=6, nt=NT, ntrials=4)
    tm = port_of(jm)
    jf = jm._fns().build_factors(jm._theta())
    with torch.no_grad():
        tf = tm._fns().build_factors(tm._theta())
    lfp = p["lfp"][::4, :, :4]
    mu_c = p["mu_c"][:, ::4]
    mu_b = np.zeros((6, NT))
    rj = J.estimate_shifts(lfp, mu_b, mu_c, T_GRID, jf, maxiter=30)
    rt = T.estimate_shifts(lfp, mu_b, mu_c, T_GRID, tf, maxiter=30, device="cpu")
    assert np.max(np.abs(rt.tau - rj.tau)) <= 1e-6
    assert np.array_equal(rt.converged, rj.converged)


def test_batched_rows_equal_rows_alone(shift_problem):
    p = shift_problem
    full = T.estimate_shifts(p["lfp"], p["mu_b"], p["mu_c"], T_GRID, p["tf"], maxiter=50, device="cpu")
    for k in (0, 4, 9):
        one = T.estimate_shifts(p["lfp"][:, :, k : k + 1], p["mu_b"], p["mu_c"], T_GRID, p["tf"],
                                maxiter=50, device="cpu")
        assert np.array_equal(one.tau[0], full.tau[k]) and one.nll[0] == full.nll[k]
        assert one.n_evals[0] == full.n_evals[k]


# ---- row_data on an analytic objective: a quadratic with each row's own centre

CENTRES = np.random.default_rng(5).normal(size=(6, 3))
WEIGHTS = np.logspace(0, 2, 3)


def quad(u, c):
    return 0.5 * torch.sum(torch.as_tensor(WEIGHTS) * torch.square(u - c), dim=-1)


def test_row_data_none_is_the_call_without_it():
    fun = lambda u: quad(u, torch.zeros(3, dtype=torch.float64))  # noqa: E731
    u0 = torch.tensor(CENTRES)
    a = lbfgs_minimize(fun, u0, max_iter=40)
    b = lbfgs_minimize(fun, u0, max_iter=40, row_data=None)
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)
    assert np.array_equal(a.n_evals, b.n_evals) and a.n_syncs == b.n_syncs


@pytest.mark.parametrize("as_tuple", [False, True])
def test_row_data_rows_equal_rows_alone(as_tuple):
    c = torch.tensor(CENTRES)
    scale = torch.linspace(0.5, 2.0, 6, dtype=torch.float64)[:, None]
    u0 = torch.zeros((6, 3), dtype=torch.float64)
    if as_tuple:
        fun = lambda u, ci, si: quad(u * si, ci)  # noqa: E731
        data = lambda rows: (c[rows], scale[rows])  # noqa: E731
    else:
        fun = quad
        data = lambda rows: c[rows]  # noqa: E731
    res = lbfgs_minimize(fun, u0, max_iter=60, row_data=data(slice(None)))
    for k in range(6):
        one = lbfgs_minimize(fun, u0[k : k + 1], max_iter=60, row_data=data(slice(k, k + 1)))
        assert torch.equal(one.u[0], res.u[k]) and torch.equal(one.f[0], res.f[k])
        assert one.n_evals[0] == res.n_evals[k] and int(one.n_iter[0]) == int(res.n_iter[k])
    want = c / scale if as_tuple else c
    assert torch.allclose(res.u, want, atol=1e-4)  # each row found its own centre
