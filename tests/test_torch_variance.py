"""PyTorch port, posterior uncertainty: ``posterior_variance`` /
``predict_variance`` against the dense GP formula and against the JAX
package, ``predict_samples`` (Matheron's rule, exact and random-Fourier-
feature priors) fed the JAX package's own random draws, and
``se_rff_features`` fed its ``w`` and ``b``.

The JAX methods draw from ``jax.random`` keys derived from ``seed``; the
port's methods take every draw as an argument (``MatheronDraws``), so the
tests rebuild JAX's draws from the same keys and pass them in.  Limits: 1e-8
of the largest magnitude for samples (measured 3e-12 to 1.1e-9), 1e-12 for the features, and :data:`VAR_RTOL` for variances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpcsd_tpu_torch as gt
from gpcsd_tpu.ops.rff import se_rff_features as j_rff
from gpcsd_tpu_torch.models import core
from gpcsd_tpu_torch.ops.rff import rff_draws, se_rff_features
from test_torch_gpcsd1d import port_of, small_jax_model
from test_torch_gpcsd2d import port_of_2d, small_jax_2d

torch.set_num_threads(2)

#: variances, port against JAX, relative to the prior variance (the factored
#: formula subtracts two numbers of that size; the 2D Gram's conditioning is
#: described in test_torch_gpcsd2d.PREDICT_RTOL).  Measured below 1e-10.
VAR_RTOL = 1e-8


def models(kind, **kw):
    if kind == "1d":
        jm = small_jax_model(seed=5, nx=6, nt=10, ntrials=2, **kw)
        return jm, port_of(jm)
    jm = small_jax_2d(seed=5, nt=8, ntrials=2, **kw)
    return jm, port_of_2d(jm)


def sites(jm, kind):
    if kind == "1d":
        return np.linspace(30.0, 470.0, 5)
    return np.concatenate([jm.x[:3] + 4.0, jm.x[6:8]])


def prior_var(jm):
    return sum(tc.params["sigma2"]["value"] for tc in jm.temporal_cov_list)


class TestPosteriorVariance:
    @pytest.mark.parametrize("kind", ["1d", "2d"])
    def test_csd_matches_dense_formula(self, kind):
        """``var_ij = prior - c^T K^-1 c`` with the dense Kronecker
        covariance inverted by numpy: rtol 1e-6 in 1D, as the JAX package's
        own test; 1e-4 in 2D, where the dense matrix has condition number
        ~1e10 and its numpy inverse is the less accurate side (measured
        2.5e-6)."""
        jm, tm = models(kind)
        z = sites(jm, kind)
        var = tm.predict_variance(z, tm.t, type="csd")
        nx, nt = tm.x.shape[0], tm.t.shape[0]
        theta = tm._theta()
        with torch.no_grad():
            Ks = tm._fns().build_ks(theta).numpy()
            Kt = tm._fns().build_kt(theta).numpy()
            if kind == "1d":
                Kphig = tm.spatial_cov.compKphig_1d(z, theta["R"], device="cpu").numpy()
            else:
                Kphig = tm.spatial_cov.compKphig_2d(z, theta["R"], tm.eps, device="cpu").numpy()
        Kinv = np.linalg.inv(np.kron(Ks, Kt) + tm.sig2n["value"] * np.eye(nx * nt))
        assert var.shape == (z.shape[0], nt)
        rtol = 1e-6 if kind == "1d" else 1e-4
        for i in range(z.shape[0]):
            for j in range(nt):
                c = np.kron(Kphig[:, i], Kt[:, j])
                want = prior_var(jm) - c @ Kinv @ c
                assert var[i, j] == pytest.approx(want, rel=rtol, abs=1e-8), (i, j)

    @pytest.mark.parametrize("kind", ["1d", "2d"])
    @pytest.mark.parametrize("field", ["csd", "lfp"])
    @pytest.mark.parametrize("noise", ["scalar", "per_channel_exact"])
    def test_matches_jax(self, kind, field, noise):
        """On and off the data's time grid: :data:`VAR_RTOL` of the largest
        prior variance; every entry between 0 and the prior."""
        kw = {} if noise == "scalar" else {"het": True, "het_noise": "exact"}
        jm, tm = models(kind, **kw)
        z = sites(jm, kind)
        for ts in (jm.t, jm.t[::2] + 0.2):
            want = np.asarray(jm.predict_variance(z, ts, type=field))
            got = tm.predict_variance(z, ts, type=field)
            assert got.shape == want.shape == (z.shape[0], ts.shape[0])
            if field == "csd":
                prior = np.full(z.shape[0], prior_var(jm))
            else:
                with torch.no_grad():
                    R = tm._theta()["R"]
                    kzz = (tm.spatial_cov.compKphi_1d(R, xp=z, device="cpu") if kind == "1d"
                           else tm.spatial_cov.compKphi_2d(R, tm.eps, xp=z, device="cpu"))
                # the diagonal of Kphi(z, z) needs z on both sides: take it from JAX
                prior = np.max(np.abs(kzz.numpy())) * prior_var(jm) * np.ones(z.shape[0])
            assert np.max(np.abs(got - want)) <= VAR_RTOL * prior.max()
            assert np.all(got >= -1e-9 * prior.max())
            if field == "csd":
                assert np.all(got <= prior[:, None])

    def test_rejects_unknown_type(self):
        for kind in ("1d", "2d"):
            _, tm = models(kind)
            with pytest.raises(ValueError, match="type"):
                tm.predict_variance(sites(tm, kind), tm.t, type="both")


# ------------------------------------------------------------------ samples

def jax_draws(seed, n_draws, n_latent, n_time_union, nx, nt, rff_dim=None):
    """The draws ``gpcsd_tpu``'s ``predict_samples`` makes from ``seed``."""
    key = jax.random.PRNGKey(seed)
    eps = jax.random.normal(key, (n_draws, n_latent, n_time_union), jnp.float64)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (n_draws, nx, nt), jnp.float64)
    if rff_dim is None:
        return core.MatheronDraws(np.asarray(eps), np.asarray(noise))
    kw, kb = jax.random.split(jax.random.fold_in(key, 2))
    w = jax.random.normal(kw, (rff_dim, n_latent), jnp.float64)
    b = jax.random.uniform(kb, (n_latent,), jnp.float64, 0.0, 2.0 * jnp.pi)
    return core.MatheronDraws(np.asarray(eps), np.asarray(noise), np.asarray(w), np.asarray(b))


class TestPredictSamples:
    @pytest.mark.parametrize("kind", ["1d", "2d"])
    @pytest.mark.parametrize("method", ["exact", "rff"])
    @pytest.mark.parametrize("grid", ["on_grid", "off_grid"])
    def test_matches_jax_from_the_same_draws(self, kind, method, grid):
        """1e-8 of the largest magnitude, trial 1, 6 draws."""
        jm, tm = models(kind)
        z = sites(jm, kind)
        ts = jm.t.reshape(-1) if grid == "on_grid" else jm.t.reshape(-1)[::2] + 0.2
        nx, nt, M = jm.x.shape[0], jm.t.shape[0], 48
        ngl = jm.spatial_cov.gl_x.size if kind == "1d" else jm.spatial_cov.gl_x_grid.shape[0]
        n_latent = M if method == "rff" else z.shape[0] + ngl
        n_union_t = nt if grid == "on_grid" else ts.size + nt
        want = jm.predict_samples(z, ts, n_draws=6, seed=4, trial=1, method=method, n_features=M)
        draws = jax_draws(4, 6, n_latent, n_union_t, nx, nt,
                          rff_dim=None if method == "exact" else (1 if kind == "1d" else 2))
        got = tm.predict_samples(z, ts, n_draws=6, trial=1, method=method, n_features=M, draws=draws)
        assert got.shape == want.shape == (6, z.shape[0], ts.size)
        assert np.all(np.isfinite(got))
        assert np.max(np.abs(got - want)) <= 1e-8 * np.max(np.abs(want))

    @pytest.mark.parametrize("kind", ["1d", "2d"])
    def test_moments_match_predict_and_variance(self, kind):
        """3000 exact draws: the sample mean within 5 standard errors of
        ``predict`` and the sample variance within 15% of
        ``predict_variance`` (its standard error is sqrt(2/3000) = 2.6%)."""
        _, tm = models(kind)
        z = sites(tm, kind)
        n = 3000
        s = tm.predict_samples(z, tm.t, n_draws=n, seed=1, trial=0, method="exact")
        mean = tm.predict(z, tm.t, type="csd")[:, :, 0]
        var = tm.predict_variance(z, tm.t, type="csd")
        assert np.all(np.abs(s.mean(axis=0) - mean) <= 5.0 * np.sqrt(var / n))
        np.testing.assert_allclose(s.var(axis=0), var, rtol=0.15)

    def test_seeded_draws_are_reproducible(self):
        _, tm = models("2d")
        z = sites(tm, "2d")
        a = tm.predict_samples(z, tm.t, n_draws=3, seed=7)
        np.testing.assert_array_equal(a, tm.predict_samples(z, tm.t, n_draws=3, seed=7))
        assert np.max(np.abs(a - tm.predict_samples(z, tm.t, n_draws=3, seed=8))) > 0
        d = core.matheron_draws(7, 3, 11, 8, 10, 8, rff_dim=2)
        assert d.eps.shape == (3, 11, 8) and d.noise.shape == (3, 10, 8)
        assert d.w_unit.shape == (2, 11) and d.b.shape == (11,)
        assert np.all((d.b >= 0) & (d.b < 2 * np.pi))
        assert core.matheron_draws(7, 3, 11, 8, 10, 8).w_unit is None

    def test_auto_selects_rff_above_2000_union_points(self, monkeypatch):
        """``method="auto"``: exact up to 2000 union points, random features
        above (a 40 x 50 rule plus 5 sites here)."""
        assert core.sample_method("auto", 2000) == "exact"
        assert core.sample_method("auto", 2001) == "rff"
        assert core.sample_method("exact", 5000) == "exact"
        with pytest.raises(ValueError, match="method"):
            core.sample_method("cholesky", 10)
        jm = small_jax_2d(seed=5, nt=8, ntrials=2)
        tm = gt.GPCSD2D(jm.lfp, jm.x, jm.t, ngl1=40, ngl2=50, eps=1.0, device="cpu")
        tm.restore_model_params(port_of_2d(jm).extract_model_params())
        calls = []
        real = core.se_rff_features

        def spy(points, ells, w_unit, b):
            calls.append((tuple(points.shape), tuple(np.shape(w_unit))))
            return real(points, ells, w_unit, b)

        monkeypatch.setattr(core, "se_rff_features", spy)
        out = tm.predict_samples(sites(jm, "2d"), tm.t, n_draws=2, n_features=32)
        assert calls == [((2005, 2), (2, 32))]
        assert out.shape == (2, 5, 8) and np.all(np.isfinite(out))
        small = port_of_2d(jm)
        small.predict_samples(sites(jm, "2d"), small.t, n_draws=2)
        assert len(calls) == 1  # 65 union points: exact


class TestRFF:
    @pytest.mark.parametrize("d", [1, 2])
    def test_features_match_jax(self, d):
        """Fed JAX's own ``w`` and ``b``: 1e-12."""
        rng = np.random.default_rng(2)
        pts = rng.uniform(0.0, 500.0, size=(40, d))
        ells = np.array([35.0, 70.0])[:d]
        key = jax.random.PRNGKey(9)
        want = j_rff(key, pts if d == 2 else pts[:, 0], ells if d == 2 else ells[0], 64)
        kw, kb = jax.random.split(key)
        w = np.asarray(jax.random.normal(kw, (d, 64), jnp.float64))
        b = np.asarray(jax.random.uniform(kb, (64,), jnp.float64, 0.0, 2.0 * jnp.pi))
        got = se_rff_features(pts if d == 2 else pts[:, 0], ells if d == 2 else ells[0], w, b)
        assert got.shape == (40, 64)
        assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 1e-12

    def test_features_approximate_the_kernel(self):
        """Phi Phi^T against the product-SE kernel with 20000 features:
        error O(1/sqrt(M)), below 0.03."""
        from gpcsd_tpu_torch.ops.kernels import se_2d

        rng = np.random.default_rng(3)
        pts = rng.uniform(0.0, 200.0, size=(30, 2))
        w, b = rff_draws(np.random.default_rng(0), 2, 20000)
        phi = se_rff_features(pts, [35.0, 70.0], w, b)
        assert float((phi @ phi.T - se_2d(pts, pts, 35.0, 70.0)).abs().max()) < 0.03
