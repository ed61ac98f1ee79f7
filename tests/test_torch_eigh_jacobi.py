"""PyTorch port, the card's batched block-Jacobi eigensolver
(``gpcsd_tpu_torch/ops/cuda/eigh.py``) through its plain version on the CPU:
against ``torch.linalg.eigh`` and the JAX package's Jacobi solver
(``gpcsd_tpu.ops.jacobi.eigh_jacobi``), its DCT congruence against the JAX
``dct_basis``, the kernel wrapper's checks, and ``ops.kronlik``'s dispatch
of the temporal factor.

Inputs are made with numpy from a seed and handed to both packages.  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from gpcsd_tpu.ops import jacobi as jj
from gpcsd_tpu.ops import kronlik as jk
from gpcsd_tpu_torch.ops import kronlik as tk
from gpcsd_tpu_torch.ops.cuda import eigh as ej
from gpcsd_tpu_torch.utils import profiling

torch.set_num_threads(2)


def se_kt(n, ell=4.0):
    """A squared-exponential covariance on a uniform grid plus jitter: a
    clustered spectrum (most eigenvalues at the jitter)."""
    t = np.arange(n, dtype=np.float64)
    return np.exp(-0.5 * (t[:, None] - t[None, :]) ** 2 / ell**2) + 1e-6 * np.eye(n)


def batch(n, seed=0):
    """Three symmetric matrices: random, an SE covariance, a graded SPD one."""
    rng = np.random.default_rng(seed + n)
    r = rng.normal(size=(n, n))
    q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    spd = (q * np.exp(-0.3 * np.arange(n))) @ q.T
    return np.stack([r + r.T, se_kt(n), 0.5 * (spd + spd.T)])


@pytest.mark.parametrize("n", [7, 24, 33, 64])
def test_dct_basis_matches_jax(n):
    """The port's DCT-II basis and the congruence ``P^T A P`` the solver
    starts from, against the JAX package's ``dct_basis`` at 1e-15."""
    want = jk.dct_basis(n)
    got = ej.dct_basis(n).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(got.T @ got, np.eye(n), rtol=0, atol=1e-14)
    a = batch(n)
    b, tol, P = ej.congruence(torch.tensor(a))
    b = b.numpy()
    npad = ej.padded_order(n)
    assert b.shape == (3, npad, npad) and npad % 32 == 0
    np.testing.assert_allclose(b[:, :n, :n], want.T @ a @ want, rtol=0,
                               atol=1e-15 * np.abs(a).max() * n)
    # the padding: decoupled, above every row's Gershgorin bound, distinct
    assert np.all(b[:, :n, n:] == 0) and np.all(b[:, n:, :n] == 0)
    pad = np.diagonal(b[:, n:, n:], axis1=1, axis2=2)
    gersh = np.abs(b[:, :n, :n]).sum(axis=2).max(axis=1)
    assert np.all(pad > gersh[:, None]) and np.all(np.diff(pad, axis=1) > 0)
    np.testing.assert_allclose(tol.numpy(), np.finfo(np.float64).eps * np.linalg.norm(a, axis=(1, 2)))


@pytest.mark.parametrize("n", [7, 24, 33, 64])
def test_plain_version_matches_lapack_and_jax(n):
    """Eigenvalues within 1e-12 ||A||_F of ``torch.linalg.eigh`` and of the
    JAX Jacobi solver; reconstruction and orthogonality within 1e-13 n; the
    padding dropped; every row converged."""
    a = batch(n)
    at = torch.tensor(a)
    info = {}
    w, v = ej.eigh_jacobi_reference(at, info=info)
    assert w.shape == (3, n) and v.shape == (3, n, n)
    assert info["unconverged"] == [False] * 3 and all(1 <= s <= ej.MAX_SWEEPS for s in info["sweeps"])
    assert torch.all(w[:, 1:] >= w[:, :-1])
    wr = torch.linalg.eigh(at)[0]
    norm = torch.linalg.matrix_norm(at)
    assert torch.all((w - wr).abs().amax(-1) <= 1e-12 * norm)
    rec = torch.linalg.matrix_norm(v @ torch.diag_embed(w) @ v.mT - at)
    assert torch.all(rec <= 1e-13 * n * norm)
    orth = (v.mT @ v - torch.eye(n, dtype=torch.float64)).abs().amax(dim=(-2, -1))
    assert torch.all(orth <= 1e-13 * n)
    for k in range(3):
        wj, vj = jj.eigh_jacobi(a[k])
        assert float((w[k] - torch.tensor(np.asarray(wj))).abs().max()) <= 1e-12 * float(norm[k])
    # the random row's eigenvalues are distinct: its eigenvectors agree up to sign
    _, vj = jj.eigh_jacobi(a[0])
    overlap = np.abs(np.sum(v[0].numpy() * np.asarray(vj), axis=0))
    np.testing.assert_allclose(overlap, 1.0, atol=1e-8)


def test_a_matrix_stopped_at_max_sweeps_reads_nan(monkeypatch):
    """With one sweep allowed, a random matrix (eight sweeps to converge at
    n = 64) stops unconverged: NaN eigenvalues, counted; the zero matrix
    beside it needs no sweep and keeps its eigenvalues."""
    a = torch.stack([torch.tensor(batch(64)[0]), torch.zeros(64, 64, dtype=torch.float64)])
    monkeypatch.setattr(ej, "MAX_SWEEPS", 1)
    info = {}
    w, _ = ej.eigh_jacobi_reference(a, info=info)
    assert info["unconverged"] == [True, False] and info["sweeps"] == [1, 0]
    assert torch.isnan(w[0]).all() and torch.equal(w[1], torch.zeros(64, dtype=torch.float64))


def test_the_kernel_refuses_what_it_cannot_solve():
    """``eigh_jacobi_cuda`` refuses a CPU tensor, another dtype and a
    non-square batch before it loads or launches anything."""
    at = torch.tensor(batch(24))
    before = ej.launch_count
    with pytest.raises(ValueError, match="CUDA tensor"):
        ej.eigh_jacobi_cuda(at)
    with pytest.raises(TypeError, match="float64"):
        ej.eigh_jacobi_cuda(at.float())
    with pytest.raises(ValueError, match=r"\(C, n, n\)"):
        ej.eigh_jacobi_cuda(at[:, :, :23])
    assert ej.launch_count == before


def sign_invariant_loss(w, v, c, b):
    return (w * c).sum() + (c * ((v.mT @ b) * v.mT).sum(-1)).sum()


def test_eigh_jacobi_function_keeps_non_finite_rows_and_the_backward(monkeypatch):
    """:class:`EighJacobi` (here over the plain version in the kernel's
    place): a row with a
    non-finite entry gives NaN eigenvalues and leaves the others as a batch
    without it; its backward is :class:`EighSafe`'s, so a sign-invariant
    loss has EighSafe's gradient (1e-8: eigenvectors of two solvers)."""
    monkeypatch.setattr(ej, "eigh_jacobi_cuda", ej.eigh_jacobi_reference)
    n = 24
    a = torch.tensor(batch(n, seed=5))
    bad = a.clone()
    bad[1, 3, 4] = float("nan")
    w, v = tk.EighJacobi.apply(bad)
    assert torch.isnan(w[1]).all() and torch.isfinite(w[[0, 2]]).all()
    w_ok, v_ok = tk.EighJacobi.apply(a[[0, 2]])
    assert torch.equal(w[[0, 2]], w_ok) and torch.equal(v[[0, 2]], v_ok)
    rng = np.random.default_rng(1)
    c = torch.tensor(rng.normal(size=n))
    b = torch.tensor(rng.normal(size=(n, n)))
    b = b + b.T
    grads = []
    for fn in (tk.EighJacobi.apply, tk.eigh_safe):
        x = a[2].clone().requires_grad_()
        (g,) = torch.autograd.grad(sign_invariant_loss(*fn(x), c, b), x)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-8, atol=1e-10)


def test_temporal_eigh_on_the_cpu_is_lapack():
    """On the CPU the temporal factor stays ``torch.linalg.eigh`` through
    :class:`EighSafe`, bit for bit, and counts its host sync as before."""
    kt = torch.tensor(se_kt(300))
    before = profiling.counters().get("host_sync.kronlik.eigh", 0)
    w, v = tk.temporal_eigh(kt)
    w2, v2 = torch.linalg.eigh(kt)
    assert torch.equal(w, w2) and torch.equal(v, v2)
    assert profiling.counters()["host_sync.kronlik.eigh"] == before + 1
    assert "kronlik.jacobi.rows" not in profiling.counters()


def test_counter_sources_join_the_registry():
    """A source added with ``add_counter_source`` is read with the registry
    and reset with it."""
    held = {"n": 3}

    def read(host):
        return {"test.device": held["n"]} if "test.host" in host else {}

    def reset():
        held["n"] = 0

    profiling.add_counter_source(read, reset)
    try:
        snap = profiling.counters()
        assert "test.device" not in snap
        profiling.count("test.host")
        assert profiling.counters()["test.device"] == 3
        profiling.reset_counters()
        assert held["n"] == 0 and profiling.counters() == {}
    finally:
        profiling._sources.remove((read, reset))
