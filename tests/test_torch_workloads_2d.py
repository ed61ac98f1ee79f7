"""PyTorch port, the 2D twins (``sim_from_gp_2d``, ``neuropixels``): the JAX
tests' classes (``tests/test_workloads.py`` ``TestSim2D``,
``TestNeuropixelsSurrogate``) at their sizes, seeds and thresholds on the
CPU, the Neuropixels real-data mode on pickles in ``extract_probe``'s schema
written here, and stage parity against the JAX workloads on the same arrays.

``TestSim2D`` feeds the twin's prior draw JAX's normals (``sample_prior``'s
``normals=``, drawn from the JAX test's ``PRNGKey(seed)``): the oracle's R^2
is a property of the draw at this tiny size (the twin's own numpy draws at
seeds 0-9 give 0.53-0.65 against the 0.6 limit; JAX's at seed 2, 0.624).

Stage tolerances (CPU float64): the prior draw on the same normals 1e-8 and
the oracle prediction 5e-7 of its largest magnitude (a 240-site SE Cholesky
with jitter 1e-7 and the 2D quadrature Gram, readings 2.7e-10 and 6.9e-8); phases through exp(i phi) 1e-7; the bootstrap on JAX's resampled
trial indices and its percentiles 1e-9; edge counts equal.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcsd_tpu import signal as jsig
from gpcsd_tpu.models.torus_graph import bootstrap_partial_plv as j_bootstrap
from gpcsd_tpu.models.torus_graph import torus_graph_fit as j_torus_graph_fit
from gpcsd_tpu.ops.forward import fwd_model_2d as j_fwd_model_2d
from gpcsd_tpu.utils.grids import expand_grid
from gpcsd_tpu_torch.models.gpcsd2d import GPCSD2D
from gpcsd_tpu_torch.workloads import neuropixels as TN
from gpcsd_tpu_torch.workloads import sim_from_gp_2d as T2
from workloads import neuropixels as JN
from workloads import sim_from_gp_2d as J2

torch.set_num_threads(2)


def max_rel(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def feed_jax_normals(monkeypatch):
    """Make ``GPCSD2D.sample_prior`` draw JAX's normals for its seed."""
    orig = GPCSD2D.sample_prior

    def fed(self, ntrials, type="csd", seed=1):
        z = jax.random.normal(jax.random.PRNGKey(seed), (ntrials, self.x.shape[0], self.t.shape[0]),
                              dtype=jnp.float64)
        return orig(self, ntrials, type=type, seed=seed, normals=np.asarray(z))

    monkeypatch.setattr(GPCSD2D, "sample_prior", fed)


SIM2D = dict(nt=10, nz1=8, nz2=30, nx2=10, ngl1=8, ngl2=16, n_restarts=2, ntrials=2, seed=2)


class TestSim2D:
    def test_oracle_quality(self, monkeypatch):
        feed_jax_normals(monkeypatch)
        timings = {}
        m, model = T2.run(**SIM2D, device="cpu", timings=timings)
        assert m["oracle_r2"] > 0.6
        assert np.isfinite(m["fitted_rmse"])
        assert m["tcsd_shape_ok"] == [4, 10, 10, 2]
        assert set(timings) == {"surrogate", "oracle", "fit", "predict", "tcsd"}
        assert model.csd_pred.shape == (8 * 30, 10, 2)

    def test_prior_draw_equals_jax_on_the_same_normals(self, monkeypatch):
        """The fed draw is JAX's: the generator's CSD equals JAX's draw."""
        t = np.linspace(0, 20, 10).reshape(-1, 1)
        z_grid = expand_grid(np.linspace(0.0, 60.0, 8), np.linspace(0.0, 1000.0, 30))
        gen = T2.make_generator(z_grid, t, 8, 16, "cpu")
        with pytest.raises(ValueError, match="normals"):
            gen.sample_prior(2, normals=np.zeros((2, 3, 10)))
        feed_jax_normals(monkeypatch)
        got, _ = gen.sample_prior(2, type="csd", seed=2)
        want, _ = jax_generator(z_grid, t).sample_prior(2, type="csd", seed=2)
        # the 240-site SE Cholesky (jitter 1e-7) amplifies roundoff: 2.7e-10
        assert max_rel(got, want) <= 1e-8


def jax_generator(z_grid, t, ngl1=8, ngl2=16):
    """The JAX workload's generator (``workloads/sim_from_gp_2d.py:47-63``)."""
    import gpcsd_tpu as g
    from gpcsd_tpu.models.covariances import GPCSDTemporalCovMatern, GPCSDTemporalCovSE

    T = J2.TRUE
    gen = g.GPCSD2D(np.zeros((z_grid.shape[0], t.shape[0], 1)), z_grid, t, a1=0.0, b1=60.0,
                    a2=0.0, b2=1000.0, ngl1=ngl1, ngl2=ngl2, eps=T["eps"],
                    temporal_cov_list=[GPCSDTemporalCovSE(t), GPCSDTemporalCovMatern(t)])
    gen.R["value"], gen.sig2n["value"] = T["R"], T["sig2n"]
    gen.spatial_cov.params["ell1"]["value"] = T["ell1"]
    gen.spatial_cov.params["ell2"]["value"] = T["ell2"]
    gen.temporal_cov_list[0].params["ell"]["value"] = T["se_ell"]
    gen.temporal_cov_list[0].params["sigma2"]["value"] = T["se_s2"]
    gen.temporal_cov_list[1].params["ell"]["value"] = T["m_ell"]
    gen.temporal_cov_list[1].params["sigma2"]["value"] = T["m_s2"]
    return gen


def test_sim_from_gp_2d_oracle_stage_parity():
    """JAX's prior draw and its LFP: the twin's generator updated with that
    LFP predicts JAX's oracle CSD."""
    t = np.linspace(0, 20, 10).reshape(-1, 1)
    z1, z2 = np.linspace(0.0, 60.0, 8), np.linspace(0.0, 1000.0, 30)
    z_grid = expand_grid(z1, z2)
    x_grid = expand_grid(np.linspace(0.0, 60.0, 4), np.linspace(0.0, 1000.0, 10))
    jgen = jax_generator(z_grid, t)
    csd, _ = jgen.sample_prior(2, type="csd", seed=2)
    lfp = np.asarray(j_fwd_model_2d(np.moveaxis(csd.reshape(8, 30, 10, 2), 3, 0), z1, z2, x_grid,
                                    J2.TRUE["R"], J2.TRUE["eps"]))
    lfp = np.moveaxis(lfp, 0, 2) + np.sqrt(0.5) * np.random.default_rng(3).normal(size=(40, 10, 2))
    tgen = T2.make_generator(z_grid, t, 8, 16, "cpu")
    for gen in (jgen, tgen):
        gen.update_lfp(lfp, t, x_grid)
        gen.predict(z_grid, t, type="csd")
    # the 2D quadrature Gram's conditioning (ROADMAP Queue C): 6.9e-8
    assert max_rel(tgen.csd_pred, jgen.csd_pred) <= 5e-7


class TestNeuropixelsSurrogate:
    def test_outlier_rejection(self, rng):
        lfp = rng.normal(size=(10, 20, 30))
        lfp[:, :, 3] *= 12.0
        keep = TN.outlier_trials(lfp)
        assert not keep[3]
        assert keep.sum() >= 25
        np.testing.assert_array_equal(keep, JN.outlier_trials(lfp))
        np.testing.assert_array_equal(TN.neuropixels_geometry(), JN.neuropixels_geometry())

    def test_pipeline_end_to_end(self):
        timings = {}
        m = TN.run(n_restarts=1, ngl1=6, ngl2=16, nt=60, ntrials=12, seed=6, nboot=2,
                   device="cpu", timings=timings)
        assert m["source"] == "surrogate"
        assert m["probeC_csd_pred_shape"] == [4, 60, m["probeC_trials_kept"]]
        assert np.isfinite(m["probeC_R"])
        for tag in ("tg_3_7_t0", "tg_3_7_t70", "tg_15_25_t0", "tg_15_25_t70"):
            assert f"{tag}_edges_bonf" in m
            w = m[f"{tag}_pplv_ci_width_mean"]
            assert np.isfinite(w) and 0.0 <= w <= 1.0
        assert set(timings) == {"surrogate", "fit", "predict", "phases", "torus_graph", "bootstrap"}

    def test_main_quick(self, tmp_path):
        TN.main(["--quick", "--device", "cpu", "--results-dir", str(tmp_path)])
        assert (tmp_path / "neuropixels.json").is_file()
        assert (tmp_path / "probeC_params.pkl").is_file()
        assert (tmp_path / "bootstrap_tg_3_7_t0.npz").is_file()


def test_neuropixels_real_data_mode(tmp_path):
    """Two probes' pickles in ``extract_probe``'s schema (t in seconds at
    2.5 kHz, y in microvolts): the window -40..110 ms is cut, the trials
    de-evoked, and the pipeline runs on them."""
    x = TN.neuropixels_geometry(nrows=6)
    rng = np.random.default_rng(0)
    fs = 2500
    t = (np.arange(-250, 500) / fs).reshape(-1, 1)  # -100..200 ms
    for i, probe in enumerate(TN.PROBES):
        lfp, _ = TN.synth_probe(x, nt=t.shape[0], ntrials=10, seed=i, device="cpu")
        y = 100.0 * lfp + 100.0 * rng.normal(size=lfp.shape)
        with open(tmp_path / f"neuropixel_viz_{probe}_m405751.pkl", "wb") as f:
            pickle.dump({"x": x, "t": t, "y": y, "fs": fs, "roi": "V1",
                         "regions": np.ones(x.shape[0], dtype=np.int64)}, f)
    probes = TN.load_probes(str(tmp_path))
    lfp, xs, tw = probes["probeC"]
    nwin = int(np.sum((t * 1000.0 >= -40.0) & (t * 1000.0 <= 110.0)))
    assert lfp.shape == (x.shape[0], nwin, 10) and tw.shape == (nwin, 1)
    assert tw[0, 0] == pytest.approx(-40.0) and tw[-1, 0] == pytest.approx(110.0)
    np.testing.assert_allclose(lfp.mean(axis=2), 0.0, atol=1e-10)
    timings = {}
    m = TN.run(data_dir=str(tmp_path), n_restarts=1, ngl1=6, ngl2=16, seed=6, nboot=2,
               device="cpu", timings=timings)
    assert m["source"] == "nwb"
    assert m["probeC_csd_pred_shape"] == [4, nwin, m["probeC_trials_kept"]]
    assert np.isfinite(m["probeD_R"])
    assert "load" in timings and "surrogate" not in timings


def test_neuropixels_analysis_stage_parity():
    """On the same CSD: the twin's band phases against JAX's, the torus
    graph's edge counts, and the bootstrap on JAX's resampled trials (keys
    ``split(PRNGKey(seed + 1000 + bi), nboot)``, one ``choice`` each)
    against JAX's replicates and percentiles."""
    rng = np.random.default_rng(7)
    nt, ntrials = 150, 16
    t = np.linspace(-40, 110, nt).reshape(-1, 1)
    csd = {p: np.cumsum(rng.normal(size=(4, nt, ntrials)), axis=1) for p in TN.PROBES}
    bands, times = ((3, 7), (15, 25)), (0.0, 70.0)
    t_inds = [int(np.argmin(np.abs(t.ravel() - tt))) for tt in times]
    fs = 1000.0 / float(np.mean(np.diff(t.ravel())))
    got = {p: TN.band_phases(c, t, bands, times, "cpu") for p, c in csd.items()}
    want = {}
    for p, c in csd.items():  # JAX's stage, ``workloads/neuropixels.py:172-180``
        for lo, hi in bands:
            ph = np.asarray(jsig.instantaneous_phase(jsig.bandpass_filtfilt(np.moveaxis(c, 1, -1),
                                                                            lo, hi, fs)))
            for tt, ti in zip(times, t_inds):
                want.setdefault((lo, hi, tt), {})[p] = ph[:, :, ti]
    assert set(got["probeC"]) == set(want)
    for key in want:
        for p in TN.PROBES:
            err = np.max(np.abs(np.exp(1j * got[p][key].numpy()) - np.exp(1j * want[key][p])))
            assert err <= 1e-7, (key, p, err)

    nboot, seed = 20, 0
    for bi, key in enumerate(sorted(want)):
        X = np.vstack([want[key]["probeC"], want[key]["probeD"]])
        tag = f"tg_{key[0]}_{key[1]}_t{int(key[2])}"
        m_fit, tg = TN.torus_metrics(torch.tensor(X), tag, device="cpu")
        jtg = j_torus_graph_fit(X)
        assert m_fit[f"{tag}_edges_bonf"] == int(np.sum(np.asarray(jtg.pvals) < 0.05 / jtg.pairs.shape[0]))
        keys = jax.random.split(jax.random.PRNGKey(seed + 1000 + bi), nboot)
        idx = np.stack([np.asarray(jax.random.choice(k, ntrials, (ntrials,), replace=True)) for k in keys])
        m_boot, pplv, lo_q, hi_q = TN.bootstrap_metrics(X, tag, nboot, indices=idx, device="cpu")
        jpplv = j_bootstrap(X, nboot, jax.random.PRNGKey(seed + 1000 + bi))
        assert np.max(np.abs(pplv - jpplv)) <= 1e-9
        jlo, jhi = np.percentile(jpplv, [2.5, 97.5], axis=1)
        assert np.max(np.abs(lo_q - jlo)) <= 1e-9 and np.max(np.abs(hi_q - jhi)) <= 1e-9
        assert m_boot[f"{tag}_pplv_ci_width_mean"] == pytest.approx(float(np.mean(jhi - jlo)), abs=1e-9)
