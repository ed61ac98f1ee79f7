"""PyTorch port, factored Kronecker likelihood: eigh_safe, comp_eig_d,
loglik, kron_solve and mykron, against the JAX package on CPU float64.

Inputs are made with numpy from a seed and handed to both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcsd_tpu.ops import kronlik as jk
from gpcsd_tpu.utility_functions import comp_eig_D as j_comp_eig_D
from gpcsd_tpu_torch.ops import kronlik as tk

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = np.load(os.path.join(HERE, "goldens", "reference_goldens.npz"))


def t64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def spd(rng, n, decay=1.0):
    """Random SPD matrix with a graded spectrum (like the covariances)."""
    q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    return (q * np.exp(-decay * np.arange(n))) @ q.T + 1e-3 * np.eye(n)


def problem(seed, nx=6, nt=14, ntrials=3, het=True):
    rng = np.random.default_rng(seed)
    Ks, Kt = spd(rng, nx, 0.8), spd(rng, nt, 0.5)
    sig2n = rng.uniform(0.02, 0.1, nx) if het else 0.05
    Y = rng.normal(size=(ntrials, nx, nt))
    return Ks, Kt, sig2n, Y


def sign_invariant_loss(w, v, c, b):
    """sum_i c_i w_i + sum_i c_i v_i^T B v_i: depends on the eigenvectors
    only through sign-invariant quadratic forms."""
    return (w * c).sum() + (c * ((v.mT @ b) * v.mT).sum(-1)).sum()


class TestEighSafe:
    def test_grad_matches_jax(self):
        """Same VJP formula on the same LAPACK factorization; the
        eigenvector term is ~1/gap-conditioned, hence rtol 1e-8."""
        rng = np.random.default_rng(0)
        a = spd(rng, 7, 0.3)
        c = rng.normal(size=7)
        b = rng.normal(size=(7, 7))
        b = b + b.T

        def jloss(m):
            w, v = jk.eigh_safe(m)
            return jnp.sum(w * c) + jnp.sum(c * jnp.sum((v.T @ b) * v.T, -1))

        want = jax.grad(jloss)(jnp.asarray(a))
        at = t64(a).requires_grad_()
        (got,) = torch.autograd.grad(sign_invariant_loss(*tk.eigh_safe(at), t64(c), t64(b)), at)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)

    def test_grad_finite_with_repeated_eigenvalue(self):
        rng = np.random.default_rng(1)
        q = np.linalg.qr(rng.normal(size=(5, 5)))[0]
        a = t64((q * np.array([1.0, 1.0, 1.0, 2.0, 3.0])) @ q.T).requires_grad_()
        b = t64(rng.normal(size=(5, 5)))
        w, v = tk.eigh_safe(a)
        (g,) = torch.autograd.grad(sign_invariant_loss(w, v, t64(rng.normal(size=5)), b + b.T), a)
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), g.numpy().T, atol=1e-14)


@pytest.mark.parametrize(
    "het,het_exact", [(False, False), (True, False), (True, True)],
    ids=["scalar", "het_approx", "het_exact"],
)
class TestLoglik:
    def test_factors_match_jax(self, het, het_exact):
        Ks, Kt, sig2n, _ = problem(2, het=het)
        want = jk.comp_eig_d(Ks, Kt, sig2n, het_exact=het_exact)
        got = tk.comp_eig_d(t64(Ks), t64(Kt), t64(sig2n), het_exact=het_exact)
        for name in ("lam_s", "lam_t", "d", "logdet_offset"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                rtol=1e-12, atol=1e-15, err_msg=name,
            )

    def test_halves_compose_to_comp_eig_d(self, het, het_exact):
        """spatial_eigh_input, the two eigh_safe calls and
        factors_from_eigenpairs give comp_eig_d's factors bit for bit, for
        one pair of matrices and for a batch of 3 (the halves a graphed pass
        replays around its eager eigh calls)."""
        one = [t64(a) for a in problem(2, het=het)[:3]]
        batch = [torch.stack(c) for c in zip(*[[t64(a) for a in problem(s, het=het)[:3]]
                                               for s in (3, 4, 5)])]
        for Ks, Kt, sig2n in (one, batch):
            want = tk.comp_eig_d(Ks, Kt, sig2n, het_exact=het_exact)
            lam_t, qt = tk.eigh_safe(Kt)
            lam_s, qs = tk.eigh_safe(tk.spatial_eigh_input(Ks, sig2n, het_exact))
            got = tk.factors_from_eigenpairs(lam_t, qt, lam_s, qs, sig2n, het_exact)
            for name in tk.KronFactors._fields:
                assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert want.d.shape == (3, 6, 14)

    def test_value_and_grad_match_jax(self, het, het_exact):
        """Value rtol 1e-12 (f64, same algorithm); gradients w.r.t. Ks, Kt
        and sig2n through both eighs at rtol 1e-8 (gap conditioning of the
        eigenvector derivative)."""
        Ks, Kt, sig2n, Y = problem(3, het=het)

        def jfun(ks, kt, s):
            return jk.loglik(jk.comp_eig_d(ks, kt, s, het_exact=het_exact), jnp.asarray(Y))

        want_v, want_g = jax.value_and_grad(jfun, argnums=(0, 1, 2))(
            jnp.asarray(Ks), jnp.asarray(Kt), jnp.asarray(sig2n)
        )
        ins = [t64(a).requires_grad_() for a in (Ks, Kt, sig2n)]
        val = tk.loglik(tk.comp_eig_d(*ins, het_exact=het_exact), t64(Y))
        got_g = torch.autograd.grad(val, ins)
        assert np.isclose(float(val.detach()), float(want_v), rtol=1e-12, atol=0.0)
        for g, w in zip(got_g, want_g):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8, atol=1e-10)

    def test_kron_solve_matches_jax(self, het, het_exact):
        Ks, Kt, sig2n, Y = problem(4, het=het)
        want = jk.kron_solve(jk.comp_eig_d(Ks, Kt, sig2n, het_exact=het_exact), jnp.asarray(Y))
        got = tk.kron_solve(tk.comp_eig_d(t64(Ks), t64(Kt), t64(sig2n), het_exact=het_exact), t64(Y))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


class TestGoldens:
    def test_mykron(self):
        np.testing.assert_allclose(
            tk.mykron(t64(GOLD["mykron_A"]), t64(GOLD["mykron_B"])).numpy(),
            GOLD["mykron"], rtol=1e-8, atol=1e-12,
        )

    def test_comp_eig_D(self):
        """Flat Dvec of the reference's comp_eig_D, scalar and per-channel
        (the latter pins the reference's Ks-eigenbasis approximation)."""
        Ks, Kt = t64(GOLD["ceD_Ks"]), t64(GOLD["ceD_Kt"])
        for sig2n, key in ((0.05, "ceD_D_hom"), (GOLD["ceD_sig2n_vec"], "ceD_D_het")):
            d = tk.comp_eig_d(Ks, Kt, t64(sig2n)).d.reshape(-1)
            np.testing.assert_allclose(d.numpy(), GOLD[key], rtol=1e-8, atol=1e-12)
            _, _, d_jax = j_comp_eig_D(GOLD["ceD_Ks"], GOLD["ceD_Kt"], sig2n)
            np.testing.assert_allclose(d.numpy(), np.asarray(d_jax), rtol=1e-12, atol=1e-15)

    def test_loglik_matches_dense_oracle(self):
        """The factored loglik equals the dense Gaussian log-density (minus
        its 2*pi constant) for the exact heteroscedastic factorization."""
        Ks, Kt, sig2n, Y = problem(5, nx=4, nt=6, ntrials=2)
        K = np.kron(Ks, Kt) + np.kron(np.diag(sig2n), np.eye(6))
        yv = Y.reshape(2, -1)
        want = -0.5 * (2 * np.linalg.slogdet(K)[1] + np.sum(yv * np.linalg.solve(K, yv.T).T))
        got = float(tk.loglik(tk.comp_eig_d(t64(Ks), t64(Kt), t64(sig2n), het_exact=True), t64(Y)))
        assert np.isclose(got, want, rtol=1e-10)

    def test_loglik_ntrials_matches_jax(self):
        """``ntrials=`` sets the trial count of the log-determinant term, as
        for one block of a larger set of trials: against JAX's ``loglik`` on
        the same block, and the two halves of 4 trials sum to the whole."""
        Ks, Kt, sig2n, Y = problem(6, ntrials=4)
        fac_t = tk.comp_eig_d(t64(Ks), t64(Kt), t64(sig2n), het_exact=True)
        fac_j = jk.comp_eig_d(Ks, Kt, sig2n, het_exact=True)
        got = float(tk.loglik(fac_t, t64(Y[:2]), ntrials=4))
        want = float(jk.loglik(fac_j, jnp.asarray(Y[:2]), ntrials=4))
        assert np.isclose(got, want, rtol=1e-12, atol=0.0)
        halves = [float(tk.loglik(fac_t, t64(Y[i:i + 2]), ntrials=2)) for i in (0, 2)]
        assert np.isclose(sum(halves), float(tk.loglik(fac_t, t64(Y))), rtol=1e-12, atol=0.0)
