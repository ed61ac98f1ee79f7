"""PyTorch port, the per-trial quadform (``quadform_rows``) on the CPU, and
the shift stage that batches its trials through it.

- ``quadform_rows_reference`` against one ``quadform`` call per trial, to
  1e-13 relative, at an odd nt and at an nx whose trials straddle the
  kernel's 64-row tiles;
- ``torch.autograd.gradcheck`` of ``QuadFormRows`` in all four inputs;
- the batched ``shift_nll`` ``(B,)`` against ``jax.vmap`` of the JAX
  ``shift_nll``, to 1e-12 relative, and ``shift_components`` (all segments
  in one pass) against ``shift_component`` per segment, bit for bit.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpcsd_tpu as g
from gpcsd_tpu.models import shifts as J
from gpcsd_tpu_torch.models import shifts as T
from gpcsd_tpu_torch.ops.cuda import quadform as qf
from gpcsd_tpu_torch.ops.kronlik import KronFactors


def inputs(seed, nx, nt, ntrials, requires_grad=False):
    rng = np.random.default_rng(seed)
    qs = np.linalg.qr(rng.normal(size=(nx, nx)))[0]
    qt = np.linalg.qr(rng.normal(size=(nt, nt)))[0]
    dinv = rng.uniform(0.5, 2.0, size=(nx, nt))
    Y = rng.normal(size=(ntrials, nx, nt))
    return [torch.tensor(a, dtype=torch.float64, requires_grad=requires_grad)
            for a in (qs, qt, dinv, Y)]


@pytest.mark.parametrize("shape", [(5, 7, 3), (24, 151, 7), (3, 10, 1)])
def test_rows_reference_matches_per_trial_quadform(shape):
    qs, qt, dinv, Y = inputs(3, *shape)
    got = qf.quadform_rows_reference(qs, qt, dinv, Y)
    assert got.shape == (shape[2],) and got.dtype == torch.float64
    want = torch.stack([qf.quadform(qs, qt, dinv, Y[b : b + 1]) for b in range(shape[2])])
    torch.testing.assert_close(got, want, rtol=1e-13, atol=0.0)
    # the wrapper on CPU tensors is the plain version, and launches nothing
    before = (qf.launch_count, qf.rows_launch_count)
    assert torch.equal(qf.quadform_rows(qs, qt, dinv, Y), got)
    assert (qf.launch_count, qf.rows_launch_count) == before
    torch.testing.assert_close(got.sum(), qf.quadform(qs, qt, dinv, Y), rtol=1e-13, atol=0.0)


def test_rows_gradcheck():
    ins = inputs(4, 4, 6, 3, requires_grad=True)
    assert torch.autograd.gradcheck(qf.QuadFormRows.apply, ins)


def test_rows_backward_matches_the_reference():
    """The hand-written backward against autograd through the plain version,
    with a cotangent that weights each trial differently."""
    a = inputs(5, 6, 9, 4, requires_grad=True)
    b = inputs(5, 6, 9, 4, requires_grad=True)
    w = torch.tensor([1.0, -2.0, 0.5, 3.0], dtype=torch.float64)
    ga = torch.autograd.grad((qf.quadform_rows(*a) * w).sum(), a)
    gb = torch.autograd.grad((qf.quadform_rows_reference(*b) * w).sum(), b)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12 * float(y.abs().max()))


def test_rows_wrapper_checks_its_inputs():
    qs, qt, dinv, Y = inputs(6, 4, 5, 2)
    with pytest.raises(ValueError, match="qt must have shape"):
        qf.quadform_rows(qs, qt[:4, :4], dinv, Y)
    with pytest.raises(TypeError, match="float64"):
        qf.quadform_rows(qs, qt, dinv, Y.float())
    with pytest.raises(ValueError, match="CUDA"):
        qf.quadform_rows_cuda(qs, qt, dinv, Y)


NT = 40
T_GRID = np.linspace(0.0, 60.0, NT)


@pytest.fixture(scope="module")
def shift_problem():
    """A dipole component shifted per trial under a noise model set by hand:
    the JAX model's factors and their copy as tensors."""
    rng = np.random.default_rng(7)
    nx, ntrials = 24, 5
    x = np.linspace(0, 2300, nx)
    xc, tc = x.reshape(-1, 1), T_GRID.reshape(1, -1)
    comp = (np.exp(-((xc - 600) ** 2) / (2 * 300**2)) - np.exp(-((xc - 1400) ** 2) / (2 * 300**2))) \
        * np.exp(-((tc - 25) ** 2) / (2 * 4**2))
    tau_true = 3.0 * rng.standard_normal(ntrials)
    lfp = np.stack([np.array([np.interp(T_GRID + tau_true[tr], T_GRID, comp[ch]) for ch in range(nx)])
                    for tr in range(ntrials)], axis=2)
    lfp += 0.02 * rng.standard_normal(lfp.shape)
    m = g.GPCSD1D(lfp - lfp.mean(2, keepdims=True), x.reshape(-1, 1), T_GRID.reshape(-1, 1), ngl=40)
    m.R["value"], m.spatial_cov.params["ell"]["value"] = 150.0, 300.0
    for tc_, (ell, s2) in zip(m.temporal_cov_list, ((8.0, 0.05), (2.0, 0.02))):
        tc_.params["ell"]["value"], tc_.params["sigma2"]["value"] = ell, s2
    m.sig2n["value"] = 4e-4
    jf = m._fns().build_factors(m._theta())
    tf = KronFactors(*(torch.tensor(np.asarray(f)) for f in jf))
    return dict(lfp=lfp, mu_c=comp[None], mu_b=np.zeros((nx, NT)), jf=jf, tf=tf)


def test_batched_shift_nll_matches_jax_vmap(shift_problem):
    p = shift_problem
    taus = np.array([[0.0], [1.7], [-3.0], [2.5 * (T_GRID[1] - T_GRID[0])], [-64.0]])
    Y = np.moveaxis(p["lfp"], 2, 0)  # (5, nx, nt)
    want = np.asarray(jax.vmap(lambda tau, y: J.shift_nll(
        tau, y, p["mu_b"], p["mu_c"], T_GRID, p["jf"], 0.5, 4.0))(jnp.asarray(taus), jnp.asarray(Y)))
    got = T.shift_nll(torch.tensor(taus), torch.tensor(Y), torch.tensor(p["mu_b"]),
                      torch.tensor(p["mu_c"]), torch.tensor(T_GRID), p["tf"], 0.5, 4.0)
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0.0)


def test_shift_components_equal_each_component_alone():
    """Values and gradients bit for bit, across a repeated knot (an empty
    interval), the edges and beyond them."""
    rng = np.random.default_rng(8)
    t = torch.tensor(np.concatenate([np.linspace(0, 10, 20), [10.0], np.linspace(10.5, 20, 11)]))
    mu = torch.tensor(rng.normal(size=(4, 6, t.numel())))
    tau = torch.tensor(np.concatenate([rng.normal(0, 8, size=(9, 4)),
                                       [[0.0, 25.0, -25.0, 10.0]]]), requires_grad=True)
    w = torch.tensor(rng.normal(size=(10, 4, 6, t.numel())))
    (g_all,) = torch.autograd.grad((T.shift_components(mu, t, tau) * w).sum(), tau)
    for s in range(4):
        ts = tau.detach()[:, s].clone().requires_grad_()
        one = T.shift_component(mu[s], t, ts)
        assert torch.equal(one, T.shift_components(mu, t, tau)[:, s].detach())
        (g,) = torch.autograd.grad((one * w[:, s]).sum(), ts)
        assert torch.equal(g, g_all[:, s])
