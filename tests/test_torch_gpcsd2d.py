"""PyTorch port, the 2D path: the 2D kernels, forward operators and
quadrature covariances, the covariance classes, ``GPCSD2D`` and the quadform
module at a 2D shape, against the JAX package on CPU float64.

Every input is made from a seed with numpy and fed to the JAX function and
its counterpart in the port; every port call runs with ``device="cpu"``.
Tolerances: 1e-12 relative for the closed-form functions (the same float64
formula in another association), 1e-10 for the log-joint value (two
eigensolvers), and the measured gradient limits stated at
:data:`GRAD_RTOL`.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpcsd_tpu as g
import gpcsd_tpu_torch as gt
from gpcsd_tpu.ops import forward as jfwd
from gpcsd_tpu.ops import kernels as jker
from gpcsd_tpu.ops import spatial as jsp
from gpcsd_tpu.utils import grids as jgrids
from gpcsd_tpu_torch import convert, paper
from gpcsd_tpu_torch.models.core import value_and_grad_rows
from gpcsd_tpu_torch.ops import forward as tfwd
from gpcsd_tpu_torch.ops import kernels as tker
from gpcsd_tpu_torch.ops import spatial as tsp
from gpcsd_tpu_torch.ops.cuda import quadform as tqf
from gpcsd_tpu_torch.utils import grids as tgrids

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1.0
#: log-joint gradient, port against JAX, relative in the 2-norm.  Measured on
#: these models (two LAPACK builds behind the regularized eigh backward):
#: 8e-11 to 6e-10; the limit leaves a factor of ~20.
GRAD_RTOL = 1e-8
#: predictions, port against JAX, in the max norm.  The 2D quadrature Gram of
#: these models has its largest eigenvalue at 1.1e9 (quadrature weights in
#: um^2) against a noise variance of 0.1, so the solve amplifies the two
#: eigensolvers' 1e-16 by up to 1e-6; measured 4e-10 to 6e-9.
PREDICT_RTOL = 1e-7


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rtol=1e-12):
    """Largest absolute difference within ``rtol`` of the largest magnitude."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


@pytest.fixture(scope="module")
def geom():
    """A 2-column staggered probe (10 sites), a 6 x 10 rule on the padded
    domain, CSD sites off the electrodes (one on a quadrature node, so a
    planar distance of exactly 0 occurs)."""
    rng = np.random.default_rng(5)
    idx = np.arange(10)
    x = np.stack([np.array([0.0, 30.0])[idx % 2], 40.0 * (idx // 2) + 20.0 * (idx % 2)], axis=1)
    rule = gt.ops.quadrature.gauss_legendre_2d(-16.0, 46.0, -100.0, 280.0, 6, 10)
    z = np.concatenate([x[:3] + rng.uniform(1.0, 9.0, size=(3, 2)), rule.xy[17:18]])
    return {"x": x, "z": z, "gl_xy": rule.xy, "gl_w": rule.w,
            "dw": np.asarray(jsp.pairwise_w(x, rule.xy)),
            "dwz": np.asarray(jsp.pairwise_w(z, rule.xy)),
            "wts": rng.normal(size=(64, 64))}


# (ell1, ell2, R) -> array, written for both packages
def _cases(geom):
    gx, gw, dw, dwz, x, z = (geom[k] for k in ("gl_xy", "gl_w", "dw", "dwz", "x", "z"))
    tgx, tgw, tdw, tdwz = t64(gx), t64(gw), t64(dw), t64(dwz)
    gl_sq = tker.sq_diffs_2d(tgx, tgx)
    return {
        "se_2d": (lambda p: jker.se_2d(x, z, p[0], p[1]),
                  lambda p: tker.se_2d(x, z, p[0], p[1])),
        "b_fwd_2d": (lambda p: jfwd.b_fwd_2d(jnp.asarray(dwz), p[2], EPS),
                     lambda p: tfwd.b_fwd_2d(tdwz, tker._mat(p[2]), EPS)),
        "quad_weights_2d": (lambda p: jsp.quad_weights_2d(dw, gw, p[2], EPS),
                            lambda p: tsp.quad_weights_2d(tdw, tgw, p[2], EPS)),
        "kphi_2d": (lambda p: jsp.kphi_2d(dw, gx, gw, p[0], p[1], p[2], EPS),
                    lambda p: tsp.kphi_2d(tdw, tgx, tgw, p[0], p[1], p[2], EPS)),
        "kphi_2d_cross": (lambda p: jsp.kphi_2d(dw, gx, gw, p[0], p[1], p[2], EPS, delta_w_p=dwz),
                          lambda p: tsp.kphi_2d(tdw, tgx, tgw, p[0], p[1], p[2], EPS,
                                                delta_w_p=tdwz)),
        "kphi_2d_precomputed_sq": (
            lambda p: jsp.kphi_2d(dw, gx, gw, p[0], p[1], p[2], EPS),
            lambda p: tsp.kphi_2d(tdw, tgx, tgw, p[0], p[1], p[2], EPS, gl_sq=gl_sq)),
        "kphig_2d": (lambda p: jsp.kphig_2d(dw, gx, z, gw, p[0], p[1], p[2], EPS),
                     lambda p: tsp.kphig_2d(tdw, tgx, t64(z), tgw, p[0], p[1], p[2], EPS)),
    }


CASE_NAMES = ["se_2d", "b_fwd_2d", "quad_weights_2d", "kphi_2d", "kphi_2d_cross",
              "kphi_2d_precomputed_sq", "kphig_2d"]
P0 = np.array([35.0, 70.0, 60.0])


class TestOps2D:
    def test_b_fwd_2d_has_a_zero_distance(self, geom):
        assert (geom["dwz"] == 0.0).sum() == 1

    @pytest.mark.parametrize("name", CASE_NAMES)
    def test_value_and_gradient(self, geom, name):
        """Value and the gradient of a fixed random contraction of the
        output with respect to (ell1, ell2, R): 1e-12 relative."""
        jf, tf = _cases(geom)[name]
        want = np.asarray(jf(jnp.asarray(P0)))
        w = geom["wts"][: want.shape[0], : want.shape[1]]
        pt = torch.tensor(P0, requires_grad=True)
        got = tf(pt)
        close(got, want)
        jg = np.asarray(jax.grad(lambda p: jnp.sum(jf(p) * w))(jnp.asarray(P0)))
        (tg,) = torch.autograd.grad(torch.sum(got * t64(w)), pt, allow_unused=True)
        tg = np.zeros(3) if tg is None else tg.numpy()
        assert np.all(np.isfinite(jg)) and np.all(np.isfinite(tg))
        assert np.max(np.abs(tg - jg)) <= 1e-12 * max(np.max(np.abs(jg)), 1e-300)

    @pytest.mark.parametrize("name", CASE_NAMES)
    def test_parameter_batch(self, geom, name):
        """``(C,)`` parameters give ``(C, n, m)``: each slice and its
        gradient against the unbatched JAX call, 1e-12 relative."""
        jf, tf = _cases(geom)[name]
        P = P0[None, :] * np.array([[1.0], [0.8], [1.3]])
        pt = torch.tensor(P, requires_grad=True)
        got = tf([pt[:, 0], pt[:, 1], pt[:, 2]])
        assert got.shape[0] == 3
        w = geom["wts"][: got.shape[1], : got.shape[2]]
        (tg,) = torch.autograd.grad(torch.sum(got * t64(w)), pt, allow_unused=True)
        for c in range(3):
            close(got[c], jf(jnp.asarray(P[c])))
            jg = np.asarray(jax.grad(lambda p: jnp.sum(jf(p) * w))(jnp.asarray(P[c])))
            if tg is not None:
                assert np.max(np.abs(tg[c].numpy() - jg)) <= 1e-12 * np.max(np.abs(jg))

    def test_b_fwd_2d_at_zero_distance(self):
        """Value and R-gradient at w = 0 exactly (eps = 1): the difference of
        logs is log((R + eps) / eps) there."""
        w = np.array([0.0, 1e-9, 3.0])
        Rt = torch.tensor(60.0, dtype=torch.float64, requires_grad=True)
        got = tfwd.b_fwd_2d(t64(w), Rt, EPS)
        close(got, jfwd.b_fwd_2d(jnp.asarray(w), 60.0, EPS))
        assert got[0].item() == pytest.approx(np.log(61.0), rel=1e-15)
        for i in range(3):
            (tg,) = torch.autograd.grad(got[i], Rt, retain_graph=True)
            jg = jax.grad(lambda R: jfwd.b_fwd_2d(jnp.asarray(w), R, EPS)[i])(60.0)
            assert float(tg) == pytest.approx(float(jg), rel=1e-12)

    def test_pairwise_w(self, geom):
        close(tsp.pairwise_w(geom["x"], geom["gl_xy"]), geom["dw"])
        close(tsp.pairwise_w(t64(geom["z"]), t64(geom["gl_xy"])), geom["dwz"])

    def test_forward_operator_and_model(self, geom):
        rng = np.random.default_rng(8)
        x1, x2 = np.array([0.0, 12.0, 30.0]), np.linspace(-20.0, 200.0, 7)
        arr = rng.normal(size=(2, 3, 7, 5))
        close(tfwd.fwd_operator_2d(x1, x2, geom["z"], 60.0, EPS),
              jfwd.fwd_operator_2d(x1, x2, geom["z"], 60.0, EPS))
        close(tfwd.fwd_model_2d(arr, x1, x2, geom["z"], 60.0, EPS),
              jfwd.fwd_model_2d(arr, x1, x2, geom["z"], 60.0, EPS))
        Rt = torch.tensor(60.0, dtype=torch.float64, requires_grad=True)
        (tg,) = torch.autograd.grad(tfwd.fwd_model_2d(arr, x1, x2, geom["z"], Rt, EPS).sum(), Rt)
        jg = jax.grad(lambda R: jnp.sum(jfwd.fwd_model_2d(arr, x1, x2, geom["z"], R, EPS)))(60.0)
        assert float(tg) == pytest.approx(float(jg), rel=1e-12)

    @pytest.mark.parametrize("name", ["normalize", "sort_grid", "expand_grid", "reduce_grid"])
    def test_grid_helpers(self, name):
        rng = np.random.default_rng(2)
        args = {
            "normalize": (rng.normal(size=(4, 5, 3)),),
            "sort_grid": (rng.integers(0, 4, size=(12, 2)).astype(float),),
            "expand_grid": (np.arange(3.0), np.arange(4.0) * 2.0),
            "reduce_grid": (jgrids.expand_grid(np.array([3.0, 1.0]), np.arange(4.0)),),
        }[name]
        got, want = getattr(tgrids, name)(*args), getattr(jgrids, name)(*args)
        if name == "reduce_grid":
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- the model

def small_jax_2d(seed=0, het=False, het_noise="approx", nt=14, ntrials=3):
    """10 sites in 2 columns, a 6 x 10 rule; the LFP is a smooth field over
    depth and time plus white noise, so that posterior means are O(1)."""
    rng = np.random.default_rng(seed)
    idx = np.arange(10)
    x = np.stack([np.array([0.0, 30.0])[idx % 2], 40.0 * (idx // 2)], axis=1)
    t = np.arange(nt).reshape(-1, 1) * 0.5
    kw = {"sig2n_prior": [g.HalfNormal(1.0) for _ in range(10)]} if het else {}
    phase = rng.uniform(0.0, 2.0 * np.pi, size=ntrials)
    lfp = 3.0 * np.sin(x[:, 1, None, None] / 60.0 + phase) * np.cos(t.T[:, :, None] / 2.0 + phase)
    lfp = lfp + 0.3 * rng.normal(size=(10, nt, ntrials))
    m = g.GPCSD2D(lfp, x, t, ngl1=6, ngl2=10, eps=EPS,
                  a1=-16.0, b1=46.0, a2=-100.0, b2=260.0, het_noise=het_noise, **kw)
    m.R["value"] = 60.0
    m.spatial_cov.params["ell1"]["value"] = 35.0
    m.spatial_cov.params["ell2"]["value"] = 70.0
    m.temporal_cov_list[0].params["ell"]["value"] = 3.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 0.8
    m.temporal_cov_list[1].params["ell"]["value"] = 1.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.4
    m.sig2n["value"] = rng.uniform(0.05, 0.3, size=10) if het else 0.1
    return m


def port_of_2d(jm, **kw):
    """Port GPCSD2D with the JAX model's data, geometry, priors and values."""
    prior = jm.sig2n["prior"]
    prior = [gt.HalfNormal(p.sd) for p in prior] if isinstance(prior, list) else gt.HalfNormal(prior.sd)
    return convert.model2d_from_reference_params(
        jm.lfp, jm.x, jm.t, jm.extract_model_params(), a1=jm.a1, b1=jm.b1, a2=jm.a2, b2=jm.b2,
        ngl1=jm.ngl1, ngl2=jm.ngl2, sig2n_prior=prior, het_noise=jm.het_noise,
        **{"device": "cpu", **kw},
    )


VARIANTS = {
    "scalar": dict(het=False),
    "per_channel_approx": dict(het=True, het_noise="approx"),
    "per_channel_exact": dict(het=True, het_noise="exact"),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    jm = small_jax_2d(seed=1, **VARIANTS[request.param])
    return jm, port_of_2d(jm)


class TestGPCSD2D:
    def test_param_set_matches_jax(self, pair):
        jm, tm = pair
        jp, tp = jm._param_set(), tm._param_set()
        assert tp.names_flat() == jp.names_flat()
        for a, b in zip(tp.bounds(), jp.bounds()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(tp.pack(tm._theta()).numpy(), np.array(jp.pack(jm._theta())),
                                   rtol=1e-13)
        assert tm.eps == jm.eps and str(tm.R["prior"]) == str(jm.R["prior"])
        for dim in ("ell1", "ell2"):
            jpar, tpar = jm.spatial_cov.params[dim], tm.spatial_cov.params[dim]
            assert str(tpar["prior"]) == str(jpar["prior"])
            assert (tpar["min"], tpar["max"]) == (jpar["min"], jpar["max"])

    def test_loglik(self, pair):
        jm, tm = pair
        assert tm.loglik() == pytest.approx(jm.loglik(), rel=1e-10)

    def test_neg_log_joint_value_and_gradient(self, pair):
        """At the model's point and two jittered ones: value 1e-10,
        gradient :data:`GRAD_RTOL` in norm."""
        jm, tm = pair
        jf, tf = jm._fns(), tm._fns()
        u0 = np.array(jf.param_set.pack(jm._theta()))
        us = u0[None] + 0.05 * np.random.default_rng(3).normal(size=(3, u0.size))
        us[0] = u0
        jvg = jax.value_and_grad(jf.neg_log_joint)
        tv, tg = value_and_grad_rows(lambda u: tf.neg_log_joint(u, tm._Y()), t64(us))
        for i, u in enumerate(us):
            jv, jg = jvg(jnp.asarray(u), jm._Y())
            assert float(tv[i]) == pytest.approx(float(jv), rel=1e-10)
            err = np.linalg.norm(tg[i].numpy() - np.asarray(jg)) / np.linalg.norm(jg)
            assert err <= GRAD_RTOL, err
            # the unbatched call gives the batched row
            ui = t64(u).requires_grad_()
            f = tf.neg_log_joint(ui, tm._Y())
            (gi,) = torch.autograd.grad(f, ui)
            assert float(f.detach()) == pytest.approx(float(tv[i]), rel=1e-12)
            assert float((gi - tg[i]).norm()) <= 1e-9 * float(gi.norm())

    def test_pass_halves_compose_to_the_log_joint(self, pair):
        """On the CPU, for 3 rows: the two halves a graphed pass replays on
        the card (run plain) around the eager eigh calls and quadratic term
        give each objective's values bit for bit and its gradient to 1e-13
        in norm (autograd adds u's partial gradients in another order)."""
        _, tm = pair
        fns, Y = tm._fns(), tm._Y()
        assert fns.graphs.whitened == (tm.het_noise == "exact" and tm._sig2n_is_vector)
        u0 = fns.param_set.pack(tm._theta())
        us = u0 + 0.05 * torch.tensor(np.random.default_rng(4).normal(size=(3, u0.numel())))
        for objective in ("log_prob", "neg_log_joint"):
            ua, ub = us.clone().requires_grad_(), us.clone().requires_grad_()
            va = getattr(fns, objective)(ua, Y)
            vb = fns.graphs.evaluate(objective, ub, Y)
            (ga,), (gb,) = torch.autograd.grad(va.sum(), ua), torch.autograd.grad(vb.sum(), ub)
            assert torch.equal(va, vb)
            assert float((ga - gb).norm()) <= 1e-13 * float(ga.norm())

    def test_log_prob_matches_jax(self, pair):
        jm, tm = pair
        u = np.array(jm._fns().param_set.pack(jm._theta())) + 0.02
        want = float(jm._fns().log_prob(jnp.asarray(u), jm._Y()))
        assert float(tm._fns().log_prob(t64(u), tm._Y())) == pytest.approx(want, rel=1e-10)

    @pytest.mark.parametrize("kind", ["csd", "lfp", "both"])
    def test_predict(self, pair, kind):
        """Totals and per-component predictions on and off the electrodes,
        within :data:`PREDICT_RTOL` of the largest magnitude."""
        jm, tm = pair
        z = np.concatenate([jm.x[:3] + 4.0, jm.x[5:7]])
        ts = jm.t[::2] + 0.1
        close(tm.predict(z, ts, type=kind), jm.predict(z, ts, type=kind), PREDICT_RTOL)
        for name in (("csd", "lfp") if kind == "both" else (kind,)):
            close(getattr(tm, f"{name}_pred"), getattr(jm, f"{name}_pred"), PREDICT_RTOL)
            scale = np.max(np.abs(getattr(jm, f"{name}_pred")))
            for a, b in zip(getattr(tm, f"{name}_pred_list"), getattr(jm, f"{name}_pred_list")):
                assert a.shape == (5, ts.size, 3)
                assert np.max(np.abs(a - b)) <= PREDICT_RTOL * scale
        np.testing.assert_array_equal(tm.x_pred, z)
        np.testing.assert_array_equal(tm.t_pred, ts.reshape(-1, 1))

    def test_fix_R_objective(self, pair):
        jm, tm = pair
        jf, tf = jm._fns(fix_R=True), tm._fns(fix_R=True)
        assert tf.param_set.names == jf.param_set.names and "R" not in tf.param_set.names
        u = np.array(jf.param_set.pack(jm._theta())) - 0.03
        want = float(jf.neg_log_joint(jnp.asarray(u), jm._Y()))
        assert float(tf.neg_log_joint(t64(u), tm._Y())) == pytest.approx(want, rel=1e-10)


class TestGPCSD2DAPI:
    def test_str_matches_jax(self):
        jm = small_jax_2d()
        assert str(port_of_2d(jm)) == str(jm)

    def test_extract_restore_round_trip(self):
        jm = small_jax_2d(het=True)
        tm = port_of_2d(jm)
        params = tm.extract_model_params()
        assert set(params) == set(jm.extract_model_params())
        for k, v in jm.extract_model_params().items():
            np.testing.assert_array_equal(np.asarray(params[k]), np.asarray(v))
        other = gt.GPCSD2D(jm.lfp, jm.x, jm.t, ngl1=6, ngl2=10, a1=-16.0, b1=46.0, a2=-100.0,
                           b2=260.0, sig2n_prior=[gt.HalfNormal(1.0)] * 10, device="cpu")
        assert other.eps == 5 * 30.0  # default: 5 x the smallest spacing
        other.restore_model_params(params)
        assert other.eps == EPS
        assert other.loglik() == pytest.approx(tm.loglik(), rel=1e-13)
        with pytest.raises(ValueError, match="temporal"):
            other.restore_model_params({**params, "temporal_ell_list": [1.0]})

    def test_flat_theta_schema(self):
        """``model2d_from_reference_params`` also takes ``_theta()``'s names."""
        jm = small_jax_2d()
        theta = {k: np.asarray(v) for k, v in jm._theta().items()}
        tm = convert.model2d_from_reference_params(
            jm.lfp, jm.x, jm.t, theta, eps=EPS, ngl1=6, ngl2=10, a1=-16.0, b1=46.0, a2=-100.0,
            b2=260.0, device="cpu")
        assert tm.loglik() == pytest.approx(jm.loglik(), rel=1e-10)
        th = convert.theta_from_numpy(jm.extract_model_params(), device="cpu")
        assert float(th["ell1"]) == 35.0 and float(th["ell2"]) == 70.0 and "ell" not in th

    def test_update_lfp(self):
        jm = small_jax_2d()
        tm = port_of_2d(jm)
        rng = np.random.default_rng(9)
        new_t = np.arange(9).reshape(-1, 1) * 0.5
        new_lfp = rng.normal(size=(10, 9))
        new_x = jm.x + np.array([2.0, 0.0])
        for m in (jm, tm):
            m.update_lfp(new_lfp, new_t, x=new_x)
        assert tm.lfp.shape == (10, 9, 1)
        np.testing.assert_allclose(tm.spatial_cov.delta_w, jm.spatial_cov.delta_w, rtol=1e-13)
        assert tm.loglik() == pytest.approx(jm.loglik(), rel=1e-10)

    def test_constructor_defaults_and_errors(self):
        jm = small_jax_2d()
        m = gt.GPCSD2D(jm.lfp[:, :, 0], jm.x, jm.t, device="cpu")
        assert m.lfp.shape == (10, 14, 1) and (m.ngl1, m.ngl2) == (20, 60)
        assert (m.a1, m.b1, m.a2, m.b2) == (0.0, 30.0, 0.0, 160.0)
        assert m.sig2n["max"] == 10.0 and np.isfinite(m.loglik())
        with pytest.raises(ValueError, match="het_noise"):
            gt.GPCSD2D(jm.lfp, jm.x, jm.t, het_noise="other", device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                gt.GPCSD2D(jm.lfp, jm.x, jm.t)
        with pytest.raises(ValueError, match="type"):
            m.predict(jm.x, jm.t, type="other")

    def test_sample_prior(self):
        """Shapes, NaN for the branch not asked for, and the spatial law:
        the Cholesky factors are those of the JAX model's covariances."""
        jm = small_jax_2d()
        tm = port_of_2d(jm)
        csd, lfp = tm.sample_prior(4, type="csd", seed=3)
        assert csd.shape == (10, 14, 4) and np.all(np.isfinite(csd)) and np.all(np.isnan(lfp))
        csd2, lfp2 = tm.sample_prior(4, type="both", seed=3)
        np.testing.assert_array_equal(csd2, csd)
        assert np.all(np.isfinite(lfp2))
        zn = np.random.default_rng(3).standard_normal((4, 10, 14))
        Ks = np.asarray(jm.spatial_cov.compute_Ks()) + 1e-7 * np.eye(10)
        Kt = sum(np.asarray(tc.compute_Kt()) for tc in jm.temporal_cov_list)
        want = np.linalg.cholesky(Ks) @ zn @ np.linalg.cholesky(Kt).T
        close(csd, np.moveaxis(want, 0, 2), 1e-9)

    def test_sample_posterior_runs(self):
        """``InferenceAPIMixin`` on a 2D model: finite constrained draws of
        every parameter and a finite Laplace Hessian."""
        from gpcsd_tpu_torch.models.inference_api import laplace_hessian

        tm = port_of_2d(small_jax_2d(nt=10, ntrials=2))
        post = tm.sample_posterior(n_chains=2, num_warmup=6, num_samples=6, seed=0, max_depth=3)
        assert set(post.theta) == {"R", "ell1", "ell2", "tm0_ell", "tm0_sigma2", "tm1_ell",
                                   "tm1_sigma2", "sig2n"}
        assert all(v.shape == (12,) and np.all(np.isfinite(v)) and np.all(v > 0)
                   for v in post.theta.values())
        u = tm._fns().param_set.pack(tm._theta()).numpy()
        H = laplace_hessian(tm._fns(), u, tm._Y())
        assert H.shape == (8, 8) and np.all(np.isfinite(H))


class TestCovariance2D:
    def test_methods_match_jax(self, geom):
        jc = g.GPCSD2DSpatialCovSE(geom["x"], a1=-16.0, b1=46.0, a2=-100.0, b2=280.0,
                                   ngl1=6, ngl2=10)
        tc = gt.GPCSD2DSpatialCovSE(geom["x"], a1=-16.0, b1=46.0, a2=-100.0, b2=280.0,
                                    ngl1=6, ngl2=10)
        for dim, v in (("ell1", 35.0), ("ell2", 70.0)):
            jc.params[dim]["value"] = tc.params[dim]["value"] = v
        np.testing.assert_array_equal(tc.gl_x_grid, jc.gl_x_grid)
        np.testing.assert_array_equal(tc.gl_w_prod, jc.gl_w_prod)
        close(tc.delta_w, jc.delta_w)
        close(tc.compute_Ks(device="cpu"), jc.compute_Ks())
        close(tc.compKphig_2d(geom["z"], 60.0, EPS, device="cpu"),
              jc.compKphig_2d(geom["z"], 60.0, EPS))
        close(tc.compKphi_2d(60.0, EPS, device="cpu"), jc.compKphi_2d(60.0, EPS))
        close(tc.compKphi_2d(60.0, EPS, xp=geom["z"], device="cpu"),
              jc.compKphi_2d(60.0, EPS, xp=geom["z"]))
        tc.reset_x(geom["x"] + 1.0)
        jc.reset_x(geom["x"] + 1.0)
        close(tc.delta_w, jc.delta_w)

    def test_default_bounds_and_draws(self, geom):
        jc = g.GPCSD2DSpatialCovSE(geom["x"], ngl1=3, ngl2=4)
        tc = gt.GPCSD2DSpatialCovSE(geom["x"], ngl1=3, ngl2=4, gen=np.random.default_rng(4))
        assert (tc.a1, tc.b1, tc.a2, tc.b2) == (jc.a1, jc.b1, jc.a2, jc.b2)
        for dim in ("ell1", "ell2"):
            assert str(tc.params[dim]["prior"]) == str(jc.params[dim]["prior"])
            assert tc.params[dim]["value"] > 0
        again = gt.GPCSD2DSpatialCovSE(geom["x"], ngl1=3, ngl2=4, gen=np.random.default_rng(4))
        assert again.params["ell1"]["value"] == tc.params["ell1"]["value"]


class TestNeuropixelsProblem:
    def test_matches_the_jax_bench_problem(self):
        """``paper.neuropixels_problem`` against ``scripts/bench_2d.py``'s
        ``build_problem``: same geometry, rule, data and parameter values
        (construction only: nothing is evaluated at the full size here)."""
        spec = importlib.util.spec_from_file_location(
            "bench_2d", os.path.join(ROOT, "scripts", "bench_2d.py"))
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
        jm = bench.build_problem(seed=2)
        tm = paper.neuropixels_problem(seed=2, device="cpu")
        assert tm.lfp.shape == (69, 375, 100) and tm.spatial_cov.gl_x_grid.shape == (3600, 2)
        np.testing.assert_array_equal(tm.x, jm.x)
        np.testing.assert_array_equal(tm.t, jm.t)
        np.testing.assert_array_equal(tm.lfp, jm.lfp)
        np.testing.assert_array_equal(tm.spatial_cov.gl_x_grid, jm.spatial_cov.gl_x_grid)
        np.testing.assert_array_equal(tm.spatial_cov.gl_w_prod, jm.spatial_cov.gl_w_prod)
        np.testing.assert_allclose(tm.spatial_cov.delta_w, jm.spatial_cov.delta_w, rtol=1e-13)
        assert tm.extract_model_params() == jm.extract_model_params()
        assert tm._param_set().names_flat() == jm._param_set().names_flat()
        assert tm._param_set().dim == 8
        for a, b in zip(tm._param_set().bounds(), jm._param_set().bounds()):
            np.testing.assert_array_equal(a, b)

    def test_small_problem_matches_jax(self):
        """The same geometry at a small size, evaluated.  Here the spatial
        Gram has norm 1e9 and rank 60 < 69, so its eigenvalues near the noise
        variance 0.1 carry 1e-16 * 1e9 / 0.1 = 1e-6 relative error in either
        eigensolver: the two logliks differ by 3.0e-6 (measured), limit 1e-5."""
        tm = paper.neuropixels_problem(seed=1, nt=12, ntrials=2, ngl1=5, ngl2=12, device="cpu")
        jm = g.GPCSD2D(tm.lfp, tm.x, tm.t, ngl1=5, ngl2=12, eps=1.0,
                       a1=tm.a1, b1=tm.b1, a2=tm.a2, b2=tm.b2)
        jm.restore_model_params(tm.extract_model_params())
        assert tm.loglik() == pytest.approx(jm.loglik(), rel=1e-5)


class TestQuadform2DShape:
    """The quadform module at a 2D shape (odd nt, nx not a multiple of 8)."""

    def inputs(self):
        rng = np.random.default_rng(6)
        nx, nt, B = 13, 25, 4
        return (np.linalg.qr(rng.normal(size=(nx, nx)))[0], np.linalg.qr(rng.normal(size=(nt, nt)))[0],
                rng.uniform(0.5, 2.0, size=(nx, nt)), rng.normal(size=(B, nx, nt)))

    def test_reference_matches_pallas_interpret(self):
        """Against the TPU kernel run in interpret mode, which accumulates in
        float32: rtol 1e-5, the JAX package's own limit for it."""
        from gpcsd_tpu.ops.pallas.quadform import quadform as j_quadform

        ins = self.inputs()
        want = float(j_quadform(*(jnp.asarray(a) for a in ins), use_pallas=True, interpret=True))
        got = float(tqf.quadform_reference(*(t64(a) for a in ins)))
        assert got == pytest.approx(want, rel=1e-5)

    def test_reference_and_wrapper_match_einsum(self):
        """Against the float64 einsum: 1e-13; on CPU tensors the wrapper
        computes the plain version and counts no launch."""
        qs, qt, dinv, Y = self.inputs()
        want = float(np.sum(np.einsum("xa,bxt,tc->bac", qs, Y, qt) ** 2 * dinv))
        before = tqf.launch_count
        assert float(tqf.quadform_reference(*map(t64, (qs, qt, dinv, Y)))) == pytest.approx(want, rel=1e-13)
        assert float(tqf.quadform(*map(t64, (qs, qt, dinv, Y)))) == pytest.approx(want, rel=1e-13)
        assert tqf.launch_count == before
