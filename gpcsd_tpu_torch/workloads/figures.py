"""The workload twins' figures and the torus-graph plots, counterpart of the
JAX workloads' ``_figure`` functions and of ``workloads/viz.py``.

Every function takes numpy arrays on the host (the twins pass what they
already hold there) and draws with matplotlib's ``Agg`` backend, imported
inside the function, so importing this module needs neither matplotlib nor
networkx.  The file names, panels and arguments are the JAX workloads':

- :func:`auditory_lfp_figure` (``auditory_lfp._figure``):
  ``auditory_lfp_<probe>.png``;
- :func:`fit_mean_function_figure` (``fit_mean_function._figure``):
  ``fit_mean_function.png``;
- :func:`neuropixels_layer_figure` (``neuropixels._layer_figure``):
  ``neuropixels_<probe>_layers.png``;
- :func:`sim_from_gp_1d_figure` (``sim_from_gp_1d._figure``):
  ``sim_from_gp_1d<tag>.png``;
- :func:`sim_from_gp_2d_figure` (``sim_from_gp_2d._figure``):
  ``sim_from_gp_2d.png``;
- :func:`simple_template_1d_figure` (``simple_template_1d._figure``):
  ``simple_template_1d.png``;
- ``viz.py``: :func:`pvals_to_matrix`, :func:`plot_pvalue_matrix`,
  :func:`plot_coupling_graph` (networkx), :func:`plot_torus_graph_summary`,
  on a :class:`~gpcsd_tpu_torch.models.torus_graph.TorusGraphResult` of
  tensors or of arrays.

:func:`draw` is how a twin calls a figure: where matplotlib does not import
(the card's host may lack it), it prints one line naming the figure it
skipped and returns, and the twin's metrics are the same.
"""

from __future__ import annotations

import importlib

import numpy as np

from ..utils.grids import normalize
from .common import maybe_savefig


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw(figure, name, *args, **kwargs):
    """``figure(*args, **kwargs)``, or, when matplotlib does not import, one
    printed line that names the skipped figure."""
    try:
        importlib.import_module("matplotlib")
    except ImportError as err:
        print(f"figure {name} skipped: matplotlib does not import ({err})")
        return None
    return figure(*args, **kwargs)


def _host(v):
    """A tensor or array as a numpy array on the host."""
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


# ---------------------------------------------------------------- workloads


def auditory_lfp_figure(fig_data, results_dir):
    """Figure-2-style panels per probe (reference
    ``fit_gpcsd_baseline.py:189-269``): trial-averaged LFP, evoked GPCSD
    total and per temporal component (slow SE / fast Matern decomposition),
    and the alpha-band CSD PLV matrix.

    :param fig_data: {probe: dict(t, lfp_evoked, csd_evoked,
        csd_components, plv)}, numpy, as the auditory twin collects it
    """
    plt = _pyplot()
    for pname, d in fig_data.items():
        comps = d["csd_components"]
        nx = d["lfp_evoked"].shape[0]
        ncols = 2 + len(comps) + 1
        fig, axes = plt.subplots(1, ncols, figsize=(3.1 * ncols, 4.2))
        t = d["t"]
        extent = [t[0], t[-1], nx, 1]
        panels = [("evoked LFP", d["lfp_evoked"])]
        panels.append(("evoked CSD (total)", d["csd_evoked"]))
        names = ["slow (SE)", "fast (Matern)"]
        for i, c in enumerate(comps):
            panels.append((f"CSD comp {i}: {names[i] if i < 2 else ''}", c))
        for ax, (name, v) in zip(axes, panels):
            vmax = np.max(np.abs(v)) or 1.0
            ax.imshow(v, aspect="auto", extent=extent, cmap="bwr", vmin=-vmax, vmax=vmax)
            ax.set_title(name, fontsize=9)
            ax.set_xlabel("time (ms)")
        axes[0].set_ylabel("electrode")
        im = axes[-1].imshow(d["plv"], vmin=0, vmax=1, cmap="viridis")
        axes[-1].set_title("alpha-band CSD PLV")
        fig.colorbar(im, ax=axes[-1], shrink=0.8)
        fig.tight_layout()
        maybe_savefig(fig, results_dir, f"auditory_lfp_{pname}.png")
        plt.close(fig)


def fit_mean_function_figure(z, t, evoked_csd, labels, n_seg, tau_est, tau_true, shift_corr,
                             results_dir):
    """Figure-4/5-style panels (reference ``fit_mean_function.py``): evoked
    CSD with watershed segment contours, estimated-vs-true shift scatter,
    and the shift correlation matrix."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(11, 4))
    vmax = np.max(np.abs(evoked_csd)) or 1.0
    axes[0].imshow(evoked_csd, aspect="auto", cmap="bwr", vmin=-vmax, vmax=vmax,
                   extent=[t[0], t[-1], z[-1], z[0]])
    if n_seg:
        axes[0].contour(t, z, labels > 0, levels=[0.5], colors="k", linewidths=0.8)
    axes[0].set_title(f"evoked CSD + {n_seg} watershed segments")
    axes[0].set_xlabel("time (ms)")
    axes[0].set_ylabel("depth (um)")
    # estimated vs true shifts (best-|corr| matched component per segment)
    for i in range(tau_est.shape[1]):
        j = int(np.argmax([abs(np.corrcoef(tau_est[:, i], tau_true[:, jj])[0, 1])
                           for jj in range(tau_true.shape[1])]))
        axes[1].scatter(tau_true[:, j], tau_est[:, i], s=8, label=f"seg {i + 1} ~ comp {j + 1}")
    lim = 1.05 * float(np.abs(tau_true).max() or 1.0)
    axes[1].plot([-lim, lim], [-lim, lim], "k--", lw=0.8)
    axes[1].set_xlabel("true shift (ms)")
    axes[1].set_ylabel("estimated shift (ms)")
    axes[1].set_title("per-trial shift recovery")
    axes[1].legend(fontsize=7)
    im = axes[2].imshow(shift_corr, vmin=-1, vmax=1, cmap="bwr")
    axes[2].set_title("shift correlation (segments)")
    fig.colorbar(im, ax=axes[2], shrink=0.8)
    fig.tight_layout()
    maybe_savefig(fig, results_dir, "fit_mean_function.png")
    plt.close(fig)


def neuropixels_layer_figure(probe, t, depths, csd_pred, results_dir):
    """Figure-6A-style panel: evoked CSD traces at the 4 probe depths
    (reference ``neuropixels/fit_gpcsd2d.py:101-113`` prediction targets).

    :param csd_pred: (4, nt, ntrials)
    """
    plt = _pyplot()
    evoked = csd_pred.mean(axis=2)  # (4, nt)
    fig, ax = plt.subplots(figsize=(6, 4))
    off = 2.2 * np.max(np.abs(evoked))
    for i, d in enumerate(depths):
        ax.plot(t, evoked[i] + i * off, label=f"{d:.0f} um")
    ax.axvline(0.0, color="k", lw=0.6, ls="--")
    ax.set_xlabel("time (ms)")
    ax.set_yticks([])
    ax.set_title(f"{probe}: evoked CSD by depth")
    ax.legend(fontsize=7)
    maybe_savefig(fig, results_dir, f"neuropixels_{probe}_layers.png")
    plt.close(fig)


def sim_from_gp_1d_figure(x, t, truth_n, gp_n, t_n, kcsd_n, gp_mse, t_mse, results_dir, tag=""):
    """Recovery panels mirroring the reference's visual check
    (``sim_from_gp_1D.py:129-194``): one-trial heatmaps, the per-electrode
    RMSE profile across depth, and per-trial MSE boxplots."""
    plt = _pyplot()
    panels = [("true CSD", truth_n), ("GPCSD", gp_n), ("tCSD", t_n)]
    if kcsd_n is not None:
        panels.append(("kCSD", kcsd_n))
    ncols = len(panels) + 2
    fig, axes = plt.subplots(1, ncols, figsize=(3.2 * ncols, 4.2))
    extent = [t[0], t[-1], x[-1], x[0]]
    vmax = 1.0
    for ax, (name, v) in zip(axes, panels):
        ax.imshow(v[:, :, 0], aspect="auto", extent=extent, cmap="bwr", vmin=-vmax, vmax=vmax)
        ax.set_title(name)
        ax.set_xlabel("time (ms)")
    axes[0].set_ylabel("depth (um)")
    # per-electrode RMSE profile (reference sim_from_gp_1D.py:184-194)
    ax = axes[len(panels)]
    for name, v in panels[1:]:
        prof = np.sqrt(np.mean((v - truth_n) ** 2, axis=(1, 2)))
        ax.plot(prof, x, label=name)
    ax.invert_yaxis()
    ax.set_xlabel("RMSE")
    ax.set_title("per-electrode RMSE")
    ax.legend(fontsize=8)
    # per-trial MSE boxplots
    ax = axes[len(panels) + 1]
    ax.boxplot([gp_mse, t_mse], tick_labels=["GPCSD", "tCSD"])
    ax.set_title("per-trial MSE")
    fig.tight_layout()
    maybe_savefig(fig, results_dir, f"sim_from_gp_1d{tag}.png")
    plt.close(fig)


def sim_from_gp_2d_figure(z1, z2, nz1, nz2, nt, truth_n, oracle_n, fitted_n, results_dir):
    """2D recovery snapshot (reference ``sim_from_gp_2D.py`` visual check):
    truth / oracle / fitted CSD over the probe plane at the time of peak CSD
    power, trial 0."""
    plt = _pyplot()
    tr = 0
    truth_r = truth_n.reshape(nz1, nz2, nt, -1)[:, :, :, tr]
    ti = int(np.argmax(np.sum(truth_r**2, axis=(0, 1))))
    panels = [
        ("true CSD", truth_r[:, :, ti]),
        ("oracle", oracle_n.reshape(nz1, nz2, nt, -1)[:, :, ti, tr]),
        ("fitted", fitted_n.reshape(nz1, nz2, nt, -1)[:, :, ti, tr]),
    ]
    fig, axes = plt.subplots(1, 3, figsize=(10.5, 4))
    vmax = max(np.abs(p[1]).max() for p in panels)
    extent = [z2[0], z2[-1], z1[-1], z1[0]]
    for ax, (name, v) in zip(axes, panels):
        im = ax.imshow(v, aspect="auto", extent=extent, cmap="bwr", vmin=-vmax, vmax=vmax)
        ax.set_title(f"{name} (t index {ti})")
        ax.set_xlabel("depth dim 2 (um)")
    axes[0].set_ylabel("dim 1 (um)")
    fig.colorbar(im, ax=axes, shrink=0.8)
    maybe_savefig(fig, results_dir, "sim_from_gp_2d.png")
    plt.close(fig)


def simple_template_1d_figure(z, t, x, csd_true, lfp_noisy, preds, results_dir):
    """Figure-1-style panel: true CSD, noisy LFP, GPCSD and tCSD estimates.

    :param preds: {name: (model, normalized GPCSD estimate)}, the
        simple-template twin's second return value
    """
    from ..models.trad import predictcsd_trad_1d

    plt = _pyplot()
    _, est = preds["white_noise"]
    tcsd = predictcsd_trad_1d(lfp_noisy[:, :, None])[:, :, 0]
    panels = [
        (normalize(csd_true), "True CSD"),
        (normalize(lfp_noisy), "LFP (noisy)"),
        (est, "GPCSD"),
        (normalize(tcsd), "tCSD"),
    ]
    fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 5))
    for ax, (img, title) in zip(axes, panels):
        v = np.nanmax(np.abs(img))
        ax.imshow(img, aspect="auto", cmap="bwr", vmin=-v, vmax=v)
        ax.set_title(title)
        ax.set_xlabel("time (ms)")
    axes[0].set_ylabel("depth")
    fig.tight_layout()
    maybe_savefig(fig, results_dir, "simple_template_1d.png")
    plt.close(fig)


# ---------------------------------------------------- torus-graph plots (viz)


def pvals_to_matrix(pvals, pairs, d):
    """(npairs,) p-values -> symmetric (d, d) matrix with NaN diagonal."""
    M = np.full((d, d), np.nan)
    for p, (j, k) in zip(_host(pvals), _host(pairs)):
        M[j, k] = M[k, j] = p
    return M


def plot_pvalue_matrix(ax, pvals, pairs, d, title="", split=None):
    """Heatmap of -log10 p per channel pair; optional probe-boundary line."""
    M = pvals_to_matrix(pvals, pairs, d)
    with np.errstate(divide="ignore"):
        img = -np.log10(np.maximum(M, 1e-300))
    im = ax.imshow(img, cmap="viridis")
    if split is not None:
        ax.axhline(split - 0.5, color="w", lw=1)
        ax.axvline(split - 0.5, color="w", lw=1)
    ax.set_title(title)
    ax.set_xlabel("channel")
    ax.set_ylabel("channel")
    return im


def plot_coupling_graph(ax, result, d, alpha=0.001, split=None, edge_weight="cond_coupling",
                        ci_lower=None, node_positions=None, title=""):
    """Bonferroni-thresholded coupling graph (reference
    ``auditory_lfp/viz_torus_graph.py``, ``neuropixels/viz_torus_graph.py``).

    :param result: TorusGraphResult
    :param split: if set, draw a bipartite two-probe layout split at this
        channel index (reference two-probe figures)
    :param ci_lower: optional (npairs,) bootstrap lower CI of the coupling:
        edges with ci_lower <= 0 are drawn dashed (reference CI shading)
    """
    import networkx as nx

    pvals = _host(result.pvals)
    weights = _host(getattr(result, edge_weight))
    pairs = _host(result.pairs)
    npairs = pairs.shape[0]
    thresh = alpha / npairs

    G = nx.Graph()
    G.add_nodes_from(range(d))
    for i, (j, k) in enumerate(pairs):
        if pvals[i] < thresh:
            solid = ci_lower is None or ci_lower[i] > 0
            G.add_edge(int(j), int(k), weight=float(weights[i]), solid=solid)

    if node_positions is None:
        if split is not None:
            node_positions = {n: (0 if n < split else 1, -(n if n < split else n - split))
                              for n in range(d)}
        else:
            node_positions = nx.circular_layout(G)

    nx.draw_networkx_nodes(G, node_positions, ax=ax, node_size=60, node_color="k")
    solid_edges = [e for e in G.edges if G.edges[e]["solid"]]
    dashed_edges = [e for e in G.edges if not G.edges[e]["solid"]]
    widths = [3.0 * G.edges[e]["weight"] for e in solid_edges]
    nx.draw_networkx_edges(G, node_positions, ax=ax, edgelist=solid_edges, width=widths)
    nx.draw_networkx_edges(G, node_positions, ax=ax, edgelist=dashed_edges, style="dashed",
                           alpha=0.5)
    ax.set_title(f"{title} ({G.number_of_edges()} edges, Bonferroni {alpha})")
    ax.axis("off")
    return G


def plot_torus_graph_summary(result, d, split=None, alpha=0.001, ci_lower=None, save_path=None):
    """Two-panel figure: p-value matrix + coupling graph."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    plot_pvalue_matrix(axes[0], result.pvals, result.pairs, d, title="-log10 p", split=split)
    plot_coupling_graph(axes[1], result, d, alpha=alpha, split=split, ci_lower=ci_lower,
                        title="coupling")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig
