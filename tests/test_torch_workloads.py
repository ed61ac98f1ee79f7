"""PyTorch port, the workload twins (``gpcsd_tpu_torch.workloads``): the
JAX tests' end-to-end cases at their sizes and thresholds
(``tests/test_workloads.py`` ``TestAuditorySurrogate``,
``TestFitMeanFunction::test_pipeline_end_to_end``), and stage parity: the
JAX workload's surrogate and parameters go through the twin's stages and
JAX's on the same arrays.

Stage tolerances (CPU float64): predictions 5e-8 of their largest
magnitude (two eigensolvers behind the same solve; reading 6.7e-9 at the
evoked mean, whose noise floor is 1e-3); phases through exp(i phi), 1e-7 (a
phase's error is the prediction's relative error over the band-passed
signal's local amplitude); segment labels equal; shifts 1e-6 ms,
``converged`` equal.  The torus graph at the auditory shape, d = 48 from
n = 20 trials, has 2256 parameters held up by the ridge alone: on the same
phases the two packages' ``phi`` differ by 5.2e-8 of its largest magnitude
(~2e7), held to 1e-6.
"""

import os
import pickle

import numpy as np
import torch

import gpcsd_tpu as g
from gpcsd_tpu import signal as jsig
from gpcsd_tpu.models.torus_graph import torus_graph_fit as j_torus_graph_fit
from gpcsd_tpu_torch.models.gpcsd1d import GPCSD1D
from gpcsd_tpu_torch.workloads import auditory_lfp as TA
from gpcsd_tpu_torch.workloads import fit_mean_function as TF
from workloads import auditory_lfp as JA
from workloads import fit_mean_function as JF


def max_rel(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


class TestAuditorySurrogate:
    def test_pipeline_end_to_end(self, tmp_path):
        timings = {}
        m, phases, tg = TA.run(n_restarts=2, nboot=2, ntime=120, ntrials=20, seed=4,
                               results_dir=str(tmp_path), device="cpu", timings=timings)
        assert m["source"] == "surrogate"
        assert phases["lateral"]["csd"].shape == (24, 20)
        assert torch.isfinite(tg.pvals).all()
        assert 0 <= m["tg_edges_bonf_001"] <= 1128
        assert 0.0 <= m["bootstrap_pplv_ci_width_mean"] <= 1.0
        assert set(timings) == {"surrogate", "fit", "predict", "phases", "torus_graph", "bootstrap"}
        assert os.path.isfile(tmp_path / "gpcsd_model_medial.pkl")
        assert os.path.isfile(tmp_path / "auditory_lfp.json")

    def test_main_quick(self, tmp_path):
        TA.main(["--quick", "--device", "cpu", "--results-dir", str(tmp_path)])
        assert os.path.isfile(tmp_path / "auditory_lfp.json")


class TestFitMeanFunction:
    def test_pipeline_end_to_end(self):
        m, res, tau_true = TF.run(nt=50, ntrials=30, n_restarts=3, seed=1, device="cpu")
        assert m["n_segments"] >= 2
        assert m["best_match_shift_corr_max"] > 0.25
        assert np.isfinite(res.tau).all()
        assert m["gpcsd_evoked_corr"] > 0.7
        assert m["gpcsd_evoked_corr"] >= m["kcsd_evoked_corr"] - 0.05
        assert res.n_evals.sum() > 0


def jax_band_phases(pred, mid):
    v = np.moveaxis(pred, 1, -1)
    return np.asarray(jsig.instantaneous_phase(jsig.bandpass_filtfilt(v, 8.0, 12.0, TA.FS)))[:, :, mid]


def test_auditory_stage_parity(tmp_path):
    """JAX surrogate -> the twin's fit writes the pickle -> JAX's fit_probe
    restores it (and writes it again) -> the twin restores JAX's pickle ->
    predict, phases, PLV and the torus graph, against JAX's stages."""
    rng = np.random.default_rng(4)
    shared = rng.uniform(0, 2 * np.pi, 20)
    probes = {
        "lateral": JA.synth_probe(4, 120, 20, coupled_phases=shared)[:2],
        "medial": JA.synth_probe(5, 120, 20, coupled_phases=shared + 0.8)[:2],
    }
    x = np.linspace(JA.A, JA.B, JA.NX).reshape(-1, 1)
    phases_j = []
    for name, (lfp, time) in probes.items():
        base = time < 0
        port_pkl, jax_pkl = str(tmp_path / f"port_{name}.pkl"), str(tmp_path / f"jax_{name}.pkl")
        TA.fit_probe(lfp[:, base, :], time[base], n_restarts=1, cache=port_pkl, device="cpu")
        with open(port_pkl, "rb") as f:
            params = pickle.load(f)
        with open(jax_pkl, "wb") as f:
            pickle.dump(params, f)
        jm = JA.fit_probe(lfp[:, base, :], time[base], cache=jax_pkl)  # restores, rewrites
        tm = TA.fit_probe(lfp[:, base, :], time[base], cache=jax_pkl, device="cpu")
        assert tm.extract_model_params()["R"] == params["R"] == jm.R["value"]
        assert np.array_equal(tm.sig2n["value"], params["sig2n"])

        csd_ph, lfp_ph, plv = TA.probe_phases(tm, lfp, time)
        trial = (time >= 0) & (time < min(500.0, time.max()))
        jm.update_lfp(lfp[:, trial, :], time[trial].reshape(-1, 1))
        jm.predict(x, time[trial].reshape(-1, 1), type="both")
        mid = jm.csd_pred.shape[1] // 2
        pred_t = tm.predict_tensors(x, time[trial], type="both")
        assert max_rel(pred_t["csd"][0].movedim(0, -1), jm.csd_pred) <= 5e-8
        for got, pred in ((csd_ph, jm.csd_pred), (lfp_ph, jm.lfp_pred)):
            want = jax_band_phases(pred, mid)
            assert np.max(np.abs(np.exp(1j * got.numpy()) - np.exp(1j * want))) <= 1e-7
        assert max_rel(plv, jsig.plv_matrix(jax_band_phases(jm.csd_pred, mid))) <= 1e-7
        phases_j.append(jax_band_phases(jm.csd_pred, mid))

    # the torus graph on JAX's phases: 48 channels, 20 trials
    X = np.vstack(phases_j)
    tg, metrics = TA.torus_stage(torch.tensor(X), nboot=0, device="cpu")
    want = j_torus_graph_fit(X)
    for f in ("phi", "kappa", "cond_coupling", "pvals"):
        assert max_rel(getattr(tg, f), getattr(want, f)) <= 1e-6, f
    assert metrics["tg_edges_bonf_001"] == int(np.sum(np.asarray(want.pvals) < 0.001 / (24 * 24)))


def test_fit_mean_function_stage_parity():
    """The twin's surrogate, the JAX model's parameters, JAX's evoked CSD:
    the twin's and JAX's prediction, segmentation and shift stages."""
    x, t, z, lfp, _, _ = TF.surrogate(nt=30, ntrials=12, seed=2)
    resid = lfp - lfp.mean(axis=2, keepdims=True)
    jm = g.GPCSD1D(resid, x.reshape(-1, 1), t.reshape(-1, 1))
    jm.R["value"], jm.spatial_cov.params["ell"]["value"] = 160.0, 250.0
    for tc, (ell, s2) in zip(jm.temporal_cov_list, ((10.0, 0.05), (3.0, 0.02))):
        tc.params["ell"]["value"], tc.params["sigma2"]["value"] = ell, s2
    jm.sig2n["value"] = 1e-3
    tm = GPCSD1D(resid, x.reshape(-1, 1), t.reshape(-1, 1), device="cpu")
    tm.restore_model_params(jm.extract_model_params())

    evoked = lfp.mean(axis=2, keepdims=True)
    for m in (jm, tm):
        m.update_lfp(evoked, t.reshape(-1, 1))
        m.predict(z.reshape(-1, 1), t.reshape(-1, 1))
    assert max_rel(tm.csd_pred, jm.csd_pred) <= 5e-8
    evoked_csd = jm.csd_pred[:, :, 0]

    lab_j, n_j, res_j, corr_j, _ = JF._shift_stage(jm, lfp, resid, evoked_csd, z, x, t)
    lab_t, n_t, res_t, corr_t, _ = TF._shift_stage(tm, lfp, resid, evoked_csd, z, x, t)
    assert n_t == n_j >= 2 and np.array_equal(lab_t, lab_j)
    assert np.max(np.abs(res_t.tau - res_j.tau)) <= 1e-6
    assert np.array_equal(res_t.converged, res_j.converged)
    assert np.max(np.abs(corr_t - corr_j)) <= 1e-6
