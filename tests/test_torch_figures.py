"""PyTorch port, the workload figures and the torus-graph plots
(``gpcsd_tpu_torch/workloads/figures.py``) against the JAX workloads'
``_figure`` functions and ``workloads/viz.py``, on the same numpy inputs:

- ``pvals_to_matrix`` bit for bit;
- each figure writes the JAX figure's file names, at the same pixel size;
- a twin's ``run(results_dir=...)`` writes its figure, and with matplotlib
  made not to import it prints one line naming the skipped figure and
  returns the same metrics;
- ``scripts/paper_figures.py`` (no twin: it reads only artifacts) draws its
  three panels from the port's banked paper run.
"""

import importlib.util
import os
import shutil
import sys

import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from gpcsd_tpu_torch.models.torus_graph import TorusGraphResult, torus_graph_fit
from gpcsd_tpu_torch.workloads import figures as F
from gpcsd_tpu_torch.workloads import sim_from_gp_1d as T_sim1d
from workloads import auditory_lfp as J_aud
from workloads import fit_mean_function as J_fmf
from workloads import neuropixels as J_npx
from workloads import sim_from_gp_1d as J_sim1d
from workloads import sim_from_gp_2d as J_sim2d
from workloads import simple_template_1d as J_tmpl
from workloads import viz as J_viz


def test_pvals_to_matrix_bit_for_bit():
    rng = np.random.default_rng(0)
    d = 9
    pairs = np.array([(j, k) for j in range(d) for k in range(j + 1, d)])
    pvals = rng.uniform(size=pairs.shape[0])
    want = J_viz.pvals_to_matrix(pvals, pairs, d)
    np.testing.assert_array_equal(F.pvals_to_matrix(pvals, pairs, d), want)
    np.testing.assert_array_equal(F.pvals_to_matrix(torch.tensor(pvals), torch.tensor(pairs), d), want)


def _auditory(rng):
    nt = 30
    data = {p: dict(t=np.arange(nt) * 1.0, lfp_evoked=rng.normal(size=(24, nt)),
                    csd_evoked=rng.normal(size=(24, nt)),
                    csd_components=[rng.normal(size=(24, nt)) for _ in range(2)],
                    plv=rng.uniform(size=(24, 24)))
            for p in ("lateral", "medial")}
    return (data,), {}


def _fit_mean_function(rng):
    z, t = np.linspace(0, 2300, 40), np.linspace(0, 60, 30)
    labels = np.zeros((40, 30), dtype=int)
    labels[5:15, 8:20], labels[20:30, 10:25] = 1, 2
    tau_est, tau_true = rng.normal(size=(12, 2)), rng.normal(size=(12, 2))
    return (z, t, rng.normal(size=(40, 30)), labels, 2, tau_est, tau_true,
            np.corrcoef(tau_est.T)), {}


def _neuropixels(rng):
    return ("probeC", np.linspace(-40, 110, 50), np.linspace(100, 3000, 4),
            rng.normal(size=(4, 50, 6))), {}


def _sim_from_gp_1d(rng):
    arrays = [rng.normal(size=(12, 20, 5)) for _ in range(4)]
    return (np.linspace(0, 2300, 12), np.linspace(0, 60, 20), *arrays,
            rng.uniform(size=5), rng.uniform(size=5)), {"tag": "_fix"}


def _sim_from_gp_2d(rng):
    nz1, nz2, nt = 4, 10, 8
    arrays = [rng.normal(size=(nz1 * nz2, nt, 3)) for _ in range(3)]
    return (np.linspace(-60, 60, nz1), np.linspace(0, 3000, nz2), nz1, nz2, nt, *arrays), {}


def _simple_template_1d(rng):
    z, t, x = np.linspace(0, 2400, 30).reshape(-1, 1), np.linspace(0, 50, 20).reshape(-1, 1), \
        np.linspace(0, 2400, 12).reshape(-1, 1)
    preds = {"white_noise": (None, rng.normal(size=(30, 20)))}
    return (z, t, x, rng.normal(size=(30, 20)), rng.normal(size=(12, 20)), preds), {}


FIGURES = {
    "auditory_lfp": (J_aud._figure, F.auditory_lfp_figure, _auditory),
    "fit_mean_function": (J_fmf._figure, F.fit_mean_function_figure, _fit_mean_function),
    "neuropixels": (J_npx._layer_figure, F.neuropixels_layer_figure, _neuropixels),
    "sim_from_gp_1d": (J_sim1d._figure, F.sim_from_gp_1d_figure, _sim_from_gp_1d),
    "sim_from_gp_2d": (J_sim2d._figure, F.sim_from_gp_2d_figure, _sim_from_gp_2d),
    "simple_template_1d": (J_tmpl._figure, F.simple_template_1d_figure, _simple_template_1d),
}


def _pngs(d):
    return {f: mpimg.imread(os.path.join(d, f)).shape for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_figure_writes_the_jax_files(name, tmp_path):
    jax_fig, port_fig, make = FIGURES[name]
    args, kwargs = make(np.random.default_rng(1))
    jax_fig(*args, results_dir=str(tmp_path / "jax"), **kwargs)
    port_fig(*args, results_dir=str(tmp_path / "port"), **kwargs)
    want = _pngs(tmp_path / "jax")
    assert want and _pngs(tmp_path / "port") == want


def test_torus_graph_summary_writes_its_file(tmp_path):
    """The two-panel summary (p-value matrix and coupling graph with
    networkx) of the port's torus-graph fit, as tensors to the port and as
    numpy arrays to ``workloads/viz.py``: the same picture size."""
    X = np.random.default_rng(2).uniform(-np.pi, np.pi, size=(6, 400))
    tr = torus_graph_fit(X, device="cpu")
    jr = TorusGraphResult(*(v.numpy() if isinstance(v, torch.Tensor) else v for v in tr))
    ci = np.linspace(-0.1, 0.2, jr.pairs.shape[0])
    import matplotlib.pyplot as plt

    want = J_viz.plot_torus_graph_summary(jr, 6, split=3, alpha=0.5, ci_lower=ci,
                                          save_path=str(tmp_path / "jax.png"))
    got = F.plot_torus_graph_summary(tr, 6, split=3, alpha=0.5, ci_lower=ci,
                                     save_path=str(tmp_path / "port.png"))
    assert mpimg.imread(tmp_path / "port.png").shape == mpimg.imread(tmp_path / "jax.png").shape
    assert [a.get_title() for a in got.axes] == [a.get_title() for a in want.axes]
    plt.close("all")


SIM1D = dict(ntrials=8, nt=20, nx=12, n_restarts=2, device="cpu")


@pytest.fixture(scope="module")
def sim1d_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("sim1d")
    metrics, _ = T_sim1d.run(results_dir=str(out), **SIM1D)
    return metrics, out


def test_twin_run_writes_its_figure(sim1d_run):
    _, out = sim1d_run
    assert (out / "sim_from_gp_1d.png").is_file() and (out / "sim_from_gp_1d.json").is_file()


def test_twin_skips_its_figure_without_matplotlib(sim1d_run, tmp_path, monkeypatch, capsys):
    metrics, _ = sim1d_run
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # ``import matplotlib`` raises
    got, _ = T_sim1d.run(results_dir=str(tmp_path), **SIM1D)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "skipped" in ln]
    assert lines == [lines[0]] and "sim_from_gp_1d.png" in lines[0] and "matplotlib" in lines[0]
    assert got == metrics
    assert not (tmp_path / "sim_from_gp_1d.png").exists()


def test_paper_figures_read_the_port_artifacts(tmp_path, monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("paper_nuts_auditory.json", "posterior_samples.npz"):
        shutil.copy(os.path.join(root, "results", "torch_paper_nuts_hetx", name), tmp_path)
    spec = importlib.util.spec_from_file_location(
        "paper_figures", os.path.join(root, "scripts", "paper_figures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["paper_figures.py", "--out-dir", str(tmp_path)])
    mod.main()
    assert sorted(os.listdir(tmp_path / "figures")) == ["marginals.png", "sig2n.png", "traces.png"]
