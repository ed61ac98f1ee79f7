"""PyTorch port, ops layer: kernels, forward model, quadrature covariances
and the quadform kernel's plain version, against the JAX package on CPU.

Inputs are made with numpy from a seed and handed to both packages.  Both
run float64 on the CPU, so the tolerances are round-off tight unless a
test says otherwise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcsd_tpu.ops import forward as jfwd
from gpcsd_tpu.ops import kernels as jker
from gpcsd_tpu.ops import quadrature as jquad
from gpcsd_tpu.ops import spatial as jsp
from gpcsd_tpu.ops.pallas.quadform import quadform as jquadform
from gpcsd_tpu_torch.ops import forward as tfwd
from gpcsd_tpu_torch.ops import kernels as tker
from gpcsd_tpu_torch.ops import quadrature as tquad
from gpcsd_tpu_torch.ops import spatial as tsp
from gpcsd_tpu_torch.ops.cuda import quadform as tqf

torch.set_num_threads(2)

#: float64 on both sides, same formulas: only summation order differs
RTOL = 1e-12

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = np.load(os.path.join(HERE, "goldens", "reference_goldens.npz"))
with open(os.path.join(HERE, "goldens", "reference_scalars.json")) as f:
    SCAL = json.load(f)


def t64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def close(ours, want, rtol=RTOL, atol=0.0):
    if isinstance(ours, torch.Tensor):
        ours = ours.detach().numpy()
    np.testing.assert_allclose(np.asarray(ours), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture
def geom():
    rng = np.random.default_rng(7)
    return {
        "x": np.sort(rng.uniform(0.0, 800.0, 9)),
        "z": np.sort(rng.uniform(-50.0, 850.0, 5)),
        "t": np.sort(rng.uniform(0.0, 40.0, 13)),
        "tp": np.sort(rng.uniform(0.0, 40.0, 6)),
    }


class TestKernels:
    @pytest.mark.parametrize("name", ["temporal_se", "temporal_matern12"])
    def test_temporal(self, geom, name):
        want = getattr(jker, name)(geom["t"], geom["tp"], 4.5, 0.7)
        close(getattr(tker, name)(geom["t"], geom["tp"], 4.5, 0.7), want)
        assert tker.TEMPORAL_KERNELS.keys() == jker.TEMPORAL_KERNELS.keys()

    def test_se(self, geom):
        close(tker.se(geom["x"], geom["z"], 180.0), jker.se(geom["x"], geom["z"], 180.0))


class TestForward:
    def test_b_fwd_and_trapezoid(self, geom):
        r = geom["x"][:, None] - geom["z"][None, :]
        close(tfwd.b_fwd_1d(t64(r), 150.0), jfwd.b_fwd_1d(r, 150.0))
        # nonuniform nodes exercise the interior (dx_prev + dx_next)/2 weights
        close(tfwd.trapezoid_weights(geom["x"]), jfwd.trapezoid_weights(geom["x"]))

    def test_operator_and_model(self, geom):
        rng = np.random.default_rng(8)
        arr = rng.normal(size=(3, geom["x"].size, 4))
        close(
            tfwd.fwd_operator_1d(geom["x"], geom["z"], 150.0, 0.8),
            jfwd.fwd_operator_1d(geom["x"], geom["z"], 150.0, 0.8),
        )
        close(
            tfwd.fwd_model_1d(arr, geom["x"], geom["z"], 150.0),
            jfwd.fwd_model_1d(arr, geom["x"], geom["z"], 150.0),
        )


class TestSpatial:
    def test_quadrature_copies(self):
        r_t, r_j = tquad.gauss_legendre(-200.0, 900.0, 24), jquad.gauss_legendre(-200.0, 900.0, 24)
        np.testing.assert_array_equal(r_t.x, r_j.x)
        np.testing.assert_array_equal(r_t.w, r_j.w)
        r2_t = tquad.gauss_legendre_2d(0.0, 64.0, -50.0, 350.0, 4, 6)
        r2_j = jquad.gauss_legendre_2d(0.0, 64.0, -50.0, 350.0, 4, 6)
        np.testing.assert_array_equal(r2_t.xy, r2_j.xy)
        np.testing.assert_array_equal(r2_t.w, r2_j.w)

    def test_kphi_kphig(self, geom):
        rule = jquad.gauss_legendre(-100.0, 900.0, 30)
        args = (rule.x, rule.w)
        close(
            tsp.quad_weights_1d(geom["x"], *args, 150.0),
            jsp.quad_weights_1d(geom["x"], *args, 150.0),
        )
        close(tsp.kphi_1d(geom["x"], *args, 200.0, 150.0),
              jsp.kphi_1d(geom["x"], *args, 200.0, 150.0))
        close(tsp.kphi_1d(geom["x"], *args, 200.0, 150.0, xp=geom["z"]),
              jsp.kphi_1d(geom["x"], *args, 200.0, 150.0, xp=geom["z"]))
        close(tsp.kphig_1d(geom["x"], geom["z"], *args, 200.0, 150.0),
              jsp.kphig_1d(geom["x"], geom["z"], *args, 200.0, 150.0))


class TestGoldens:
    """The reference-execution goldens that touch the ported functions, at
    the JAX package's own golden tolerance (rtol 1e-8)."""

    def test_forward(self):
        close(tfwd.b_fwd_1d(t64(GOLD["b_fwd_1d_in"]), 150.0), GOLD["b_fwd_1d"], 1e-8, 1e-12)
        z6 = np.linspace(0.0, 700.0, 6)
        xs = np.linspace(0.0, 700.0, 8)
        close(tfwd.fwd_model_1d(GOLD["fwd1d_csd"], z6, xs, 150.0), GOLD["fwd1d"], 1e-8, 1e-12)

    def test_priors(self):
        from gpcsd_tpu_torch.models.priors import HalfNormal, InvGamma

        for (l, u), (alpha, beta) in zip(GOLD["invgamma_pairs"], GOLD["invgamma_alpha_beta"]):
            p = InvGamma.from_interval(l, u)
            assert np.isclose(p.alpha, alpha, rtol=1e-8) and np.isclose(p.beta, beta, rtol=1e-8)
        p = InvGamma.from_interval(30.0, 100.0)
        close(p.lpdf(GOLD["invgamma_lpdf_pts"]), GOLD["invgamma_lpdf"], 1e-8, 1e-12)
        close(HalfNormal(SCAL["halfnormal_sd"]).lpdf(np.array([0.01, 0.1, 0.3])),
              GOLD["halfnormal_lpdf"], 1e-8, 1e-12)

    def test_covariances(self):
        from gpcsd_tpu_torch.models.covariances import (
            GPCSD1DSpatialCovSE,
            GPCSDTemporalCovMatern,
            GPCSDTemporalCovSE,
        )

        scov = GPCSD1DSpatialCovSE(np.linspace(0.0, 700.0, 8)[:, None], a=-200.0, b=900.0, ngl=24)
        scov.params["ell"]["value"] = 200.0
        close(scov.gl_x, GOLD["spat1d_gl_x"], 1e-8, 1e-12)
        close(scov.gl_w, GOLD["spat1d_gl_w"], 1e-8, 1e-12)
        close(scov.compute_Ks(), GOLD["spat1d_Ks"], 1e-8, 1e-12)
        close(scov.compKphi_1d(150.0), GOLD["spat1d_Kphi"], 1e-8, 1e-12)
        zq = np.linspace(50.0, 650.0, 5)[:, None]
        close(scov.compKphi_1d(150.0, xp=zq), GOLD["spat1d_Kphi_xp"], 1e-8, 1e-12)
        close(scov.compKphig_1d(zq, 150.0), GOLD["spat1d_Kphig"], 1e-8, 1e-12)
        assert np.isclose(scov.params["ell"]["min"], SCAL["spat1d_ell_min"])
        assert np.isclose(scov.params["ell"]["max"], SCAL["spat1d_ell_max"])
        assert np.isclose(scov.params["ell"]["prior"].alpha, SCAL["spat1d_ell_prior_alpha"])
        assert np.isclose(scov.params["ell"]["prior"].beta, SCAL["spat1d_ell_prior_beta"])

        ts = np.arange(12.0)[:, None]
        tstar = np.linspace(0.0, 11.0, 7)[:, None]
        tse, tma = GPCSDTemporalCovSE(ts), GPCSDTemporalCovMatern(ts)
        tse.params["ell"]["value"], tse.params["sigma2"]["value"] = 7.0, 1.1
        tma.params["ell"]["value"], tma.params["sigma2"]["value"] = 2.5, 0.6
        close(tse.compute_Kt(), GOLD["tempSE_Kt"], 1e-8, 1e-12)
        close(tse.compute_Kt(tstar), GOLD["tempSE_Kt_star"], 1e-8, 1e-12)
        close(tma.compute_Kt(), GOLD["tempMa_Kt"], 1e-8, 1e-12)
        close(tma.compute_Kt(tstar), GOLD["tempMa_Kt_star"], 1e-8, 1e-12)
        assert np.isclose(tse.params["ell"]["min"], SCAL["tempSE_ell_min"])
        assert np.isclose(tse.params["ell"]["max"], SCAL["tempSE_ell_max"])
        assert np.isclose(tse.params["ell"]["prior"].alpha, SCAL["tempSE_ell_prior_alpha"])
        assert np.isclose(tse.params["sigma2"]["min"], SCAL["tempSE_sigma2_min"])
        assert tse.params["sigma2"]["max"] == SCAL["tempSE_sigma2_max"]


def quadform_inputs(seed, nx, nt, ntrials):
    rng = np.random.default_rng(seed)
    qs = np.linalg.qr(rng.normal(size=(nx, nx)))[0]
    qt = np.linalg.qr(rng.normal(size=(nt, nt)))[0]
    dinv = rng.uniform(0.5, 2.0, size=(nx, nt))
    Y = rng.normal(size=(ntrials, nx, nt))
    return qs, qt, dinv, Y


class TestQuadform:
    @pytest.mark.parametrize("shape", [(8, 32, 5), (7, 129, 3)])
    def test_reference_matches_jax(self, shape):
        """rtol 1e-12 against the f64 XLA einsum; 1e-5 against the Pallas
        kernel in interpret mode, which casts everything to f32."""
        args = quadform_inputs(1, *shape)
        ours = float(tqf.quadform(*map(t64, args)))
        want = float(jquadform(*map(jnp.asarray, args), use_pallas=False))
        assert np.isclose(ours, want, rtol=1e-12, atol=0.0)
        pallas = float(jquadform(*map(jnp.asarray, args), use_pallas=True, interpret=True))
        assert np.isclose(ours, pallas, rtol=1e-5, atol=0.0)

    def test_grads_match_jax(self):
        """Autograd backward vs jax.grad of the JAX einsum path: the same
        contractions in f64, so rtol 1e-10 (summation order only)."""
        qs, qt, dinv, Y = quadform_inputs(2, 6, 20, 4)
        want = jax.grad(
            lambda a, b, c, y: jquadform(a, b, c, y, use_pallas=False), argnums=(0, 1, 2, 3)
        )(*map(jnp.asarray, (qs, qt, dinv, Y)))
        ins = [t64(a).requires_grad_() for a in (qs, qt, dinv, Y)]
        got = torch.autograd.grad(tqf.quadform(*ins), ins)
        for g, w in zip(got, want):
            close(g, w, rtol=1e-10, atol=1e-12)

    def test_grads_match_finite_differences(self):
        """Central differences along a random direction, step 1e-6: the
        truncation error is O(h^2) ~ 1e-12 relative and cancellation
        ~1e-10, so 1e-7 relative is a safe bound."""
        qs, qt, dinv, Y = quadform_inputs(3, 5, 11, 3)
        ins = [t64(a).requires_grad_() for a in (qs, qt, dinv, Y)]
        grads = torch.autograd.grad(tqf.quadform(*ins), ins)
        rng = np.random.default_rng(4)
        h = 1e-6
        for k, g in enumerate(grads):
            d = t64(rng.normal(size=g.shape))
            plus = [a.detach().clone() for a in ins]
            minus = [a.detach().clone() for a in ins]
            plus[k] += h * d
            minus[k] -= h * d
            fd = (float(tqf.quadform(*plus)) - float(tqf.quadform(*minus))) / (2 * h)
            assert np.isclose(float(torch.sum(g * d)), fd, rtol=1e-7), k

    def test_wrapper_rejects_bad_inputs(self):
        qs, qt, dinv, Y = map(t64, quadform_inputs(5, 4, 9, 2))
        with pytest.raises(ValueError, match="shape"):
            tqf.quadform(qs, qt, dinv[:, :-1], Y)
        with pytest.raises(TypeError, match="float64"):
            tqf.quadform(qs.float(), qt, dinv, Y)
        with pytest.raises(ValueError, match="contiguous"):
            tqf.quadform(qs.mT, qt, dinv, Y)
        with pytest.raises(ValueError, match="ntrials"):
            tqf.quadform(qs, qt, dinv, Y[0])
        with pytest.raises(ValueError, match="CUDA"):
            tqf.quadform_cuda(qs, qt, dinv, Y)

    def test_cpu_path_does_not_launch(self):
        before = tqf.launch_count
        tqf.quadform(*map(t64, quadform_inputs(6, 4, 9, 2)))
        assert tqf.launch_count == before

