"""Torus graph: exponential-family graphical model for multivariate phases,
counterpart of ``gpcsd_tpu.models.torus_graph``.

Subsumes the reference's external dependency ``pyTG.torusGraphs`` (used at
``auditory_lfp/torus_graph_fit.py:31-38,55-56`` and
``neuropixels/fit_torus_graph.py:34-37``): a pairwise exponential-family
density on the d-torus (Klein, Orellana, Brincat, Miller & Kass, AOAS 2020),

    p(x | phi) = exp(phi^T S(x)) / Z(phi),   x in [0, 2pi)^d

with sufficient statistics selected by ``sel_mode = (marginals,
differences, sums)``:
- marginals: cos x_j, sin x_j                       (2 per node)
- differences: cos(x_j - x_k), sin(x_j - x_k)      (2 per pair)
- sums: cos(x_j + x_k), sin(x_j + x_k)             (2 per pair)

The phase-differences submodel used throughout the GPCSD paper is
``sel_mode=(False, True, False)``.

Estimation is score matching, which is closed form for this family: with
per-sample estimating function g(x; phi) = G(x) phi - H(x), where
G(x) = grad_S grad_S^T and H(x) = -laplacian(S) = c . S(x) (c = 1 for node
terms, 2 for pairwise), the estimator solves

    phi_hat = Gamma_hat^{-1} H_hat,
    Gamma_hat = mean_i G(x_i),  H_hat = mean_i c . S(x_i)

with sandwich covariance cov(phi_hat) = Gamma^{-1} V Gamma^{-1} / n,
V = mean_i g_i g_i^T evaluated at phi_hat.  Per-edge significance is the
Wald chi^2 test on that pair's coefficient block.

Gamma_hat is assembled per node: each statistic touches at most two
coordinates, so node l contributes a dense block over only the q = O(d)
statistics involving l, O(d^3 n) in all instead of O(d^4 n).  Every node
involves the same number of statistics, so the d blocks are computed as
one batched product and added into Gamma with one ``index_put_``.  Every
function takes a leading batch axis on X: the bootstrap's replicates are
that axis, and :func:`bootstrap_partial_plv` computes for them only what
its result needs (``phi`` and the partial PLV), not the sandwich
covariance and the Wald tests, which eager PyTorch would compute and
discard.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import config


def pair_index(d: int) -> np.ndarray:
    """(npairs, 2) array of node pairs j<k in lexicographic order."""
    return np.array([(j, k) for j in range(d) for k in range(j + 1, d)], dtype=np.int32)


class TGLayout(NamedTuple):
    """Static index layout of the phi vector for (d, sel_mode)."""

    d: int
    sel_mode: Tuple[bool, bool, bool]
    pairs: np.ndarray  # (npairs, 2)
    m: int  # total number of parameters
    marg_off: int  # offset of marginal block (or -1)
    diff_off: int
    sum_off: int


def layout(d: int, sel_mode=(False, True, False)) -> TGLayout:
    pairs = pair_index(d)
    npairs = pairs.shape[0]
    off = 0
    marg_off = diff_off = sum_off = -1
    if sel_mode[0]:
        marg_off = off
        off += 2 * d
    if sel_mode[1]:
        diff_off = off
        off += 2 * npairs
    if sel_mode[2]:
        sum_off = off
        off += 2 * npairs
    return TGLayout(d=d, sel_mode=tuple(sel_mode), pairs=pairs, m=off,
                    marg_off=marg_off, diff_off=diff_off, sum_off=sum_off)


def suff_stats(lay: TGLayout, X):
    """S(X): (..., m, n) sufficient statistics for X (..., d, n) in radians;
    marginals ordered [cos(all nodes); sin(all nodes)]."""
    j = torch.as_tensor(lay.pairs[:, 0], dtype=torch.long, device=X.device)
    k = torch.as_tensor(lay.pairs[:, 1], dtype=torch.long, device=X.device)
    parts = []
    if lay.sel_mode[0]:
        parts += [torch.cos(X), torch.sin(X)]
    if lay.sel_mode[1]:
        delta = X[..., j, :] - X[..., k, :]
        parts += [torch.cos(delta), torch.sin(delta)]
    if lay.sel_mode[2]:
        sig = X[..., j, :] + X[..., k, :]
        parts += [torch.cos(sig), torch.sin(sig)]
    return torch.cat(parts, dim=-2)


def _c_vector(lay: TGLayout, like):
    """Laplacian scaling c: 1 for node stats, 2 for pairwise stats."""
    cs = []
    if lay.sel_mode[0]:
        cs.append(np.ones(2 * lay.d))
    if lay.sel_mode[1]:
        cs.append(2 * np.ones(2 * lay.pairs.shape[0]))
    if lay.sel_mode[2]:
        cs.append(2 * np.ones(2 * lay.pairs.shape[0]))
    return torch.as_tensor(np.concatenate(cs), dtype=like.dtype, device=like.device)


def _node_stat_indices(lay: TGLayout, l: int) -> np.ndarray:
    """Indices of phi entries whose statistic involves coordinate l."""
    idx = []
    npairs = lay.pairs.shape[0]
    if lay.sel_mode[0]:
        idx += [lay.marg_off + l, lay.marg_off + lay.d + l]
    involved = np.nonzero((lay.pairs[:, 0] == l) | (lay.pairs[:, 1] == l))[0]
    if lay.sel_mode[1]:
        idx += list(lay.diff_off + involved) + list(lay.diff_off + npairs + involved)
    if lay.sel_mode[2]:
        idx += list(lay.sum_off + involved) + list(lay.sum_off + npairs + involved)
    return np.asarray(idx, dtype=np.int64)


class _NodeIndex(NamedTuple):
    """Per node l (rows), the q statistics involving l, as index arrays
    (d, q), and per involved pair its coordinates and the sign of
    d/dx_l (x_j - x_k), (d, d - 1)."""

    stat: torch.Tensor  # (d, q) phi indices
    jj: torch.Tensor  # (d, d-1)
    kk: torch.Tensor
    sign: torch.Tensor  # (d, d-1) float: +1 where l is j


def _node_index(lay: TGLayout, device) -> _NodeIndex:
    stat, jj, kk, sign = [], [], [], []
    for l in range(lay.d):
        involved = np.nonzero((lay.pairs[:, 0] == l) | (lay.pairs[:, 1] == l))[0]
        stat.append(_node_stat_indices(lay, l))
        jj.append(lay.pairs[involved, 0])
        kk.append(lay.pairs[involved, 1])
        sign.append(np.where(lay.pairs[involved, 0] == l, 1.0, -1.0))
    return _NodeIndex(*(torch.as_tensor(np.stack(a), device=device) for a in (stat, jj, kk, sign)))


def _node_derivs(lay: TGLayout, nodes: _NodeIndex, X):
    """dS/dx_l restricted to the stats involving l, for every node l at
    once: (..., d, q, n), rows in the order of ``nodes.stat``."""
    rows = []
    if lay.sel_mode[0]:
        rows += [-torch.sin(X)[..., None, :], torch.cos(X)[..., None, :]]
    sign = nodes.sign.to(X.dtype)[..., None]  # (d, d-1, 1)
    if lay.sel_mode[1]:
        # d cos(delta)/dx_l = -sin(delta)*sign_l ; d sin(delta)/dx_l = cos(delta)*sign_l
        delta = X[..., nodes.jj, :] - X[..., nodes.kk, :]  # (..., d, d-1, n)
        rows += [-torch.sin(delta) * sign, torch.cos(delta) * sign]
    if lay.sel_mode[2]:
        sig = X[..., nodes.jj, :] + X[..., nodes.kk, :]
        rows += [-torch.sin(sig), torch.cos(sig)]
    return torch.cat(rows, dim=-2)


def _gamma(lay: TGLayout, nodes: _NodeIndex, C, n):
    """Gamma (..., m, m) from the node derivatives C (..., d, q, n)."""
    batch = C.shape[:-3]
    blocks = ((C @ C.mT) / n).reshape(-1, *C.shape[-3:-1], C.shape[-2])  # (B, d, q, q)
    G = torch.zeros((blocks.shape[0], lay.m, lay.m), dtype=C.dtype, device=C.device)
    b = torch.arange(blocks.shape[0], device=C.device)[:, None, None, None]
    G.index_put_((b, nodes.stat[:, :, None], nodes.stat[:, None, :]), blocks, accumulate=True)
    return G.reshape(*batch, lay.m, lay.m)


def gamma_matrix(lay: TGLayout, X):
    """Gamma_hat = mean_i grad_S grad_S^T, assembled per node; (..., m, m)."""
    nodes = _node_index(lay, X.device)
    return _gamma(lay, nodes, _node_derivs(lay, nodes, X), X.shape[-1])


def _score(nodes: _NodeIndex, C, phi):
    """d/dx_l [phi^T S(x)] per sample from the node derivatives: (..., d, n)."""
    return torch.einsum("...lq,...lqn->...ln", phi[..., nodes.stat], C)


def score_vector(lay: TGLayout, X, phi):
    """Model score d/dx_l [phi^T S(x)] for each sample: (..., d, n)."""
    nodes = _node_index(lay, X.device)
    return _score(nodes, _node_derivs(lay, nodes, X), phi)


class TorusGraphResult(NamedTuple):
    phi: torch.Tensor  # (m,)
    phi_cov: torch.Tensor  # (m, m) sandwich covariance of phi_hat
    pairs: np.ndarray  # (npairs, 2)
    pvals: torch.Tensor  # (npairs,) per-edge Wald test p-values
    kappa: torch.Tensor  # (npairs,) coupling magnitudes ||phi_pair||
    cond_coupling: torch.Tensor  # (npairs,) partial PLV I1(kappa)/I0(kappa)
    graph: torch.Tensor  # (npairs,) bool at alpha=0.05 Bonferroni


def _pair_blocks(lay: TGLayout):
    """(npairs, q) index array of each pair's phi entries (q = 2 or 4)."""
    npairs = lay.pairs.shape[0]
    cols = []
    if lay.sel_mode[1]:
        cols += [lay.diff_off + np.arange(npairs), lay.diff_off + npairs + np.arange(npairs)]
    if lay.sel_mode[2]:
        cols += [lay.sum_off + np.arange(npairs), lay.sum_off + npairs + np.arange(npairs)]
    return np.stack(cols, axis=1)  # (npairs, q)


def _solve_phi(lay, nodes, X):
    """Score-matching estimate: returns (phi, Gamma + ridge, C, S), phi (..., m)."""
    n = X.shape[-1]
    S = suff_stats(lay, X)  # (..., m, n)
    H = torch.mean(_c_vector(lay, X)[:, None] * S, dim=-1)
    C = _node_derivs(lay, nodes, X)
    Gamma = _gamma(lay, nodes, C, n)
    # adaptive ridge: keeps the solve stable when channels are near-
    # deterministically coupled (collinear statistics -> singular Gamma)
    diag = torch.diagonal(Gamma, dim1=-2, dim2=-1)
    diag += 1e-8 * torch.mean(diag, dim=-1, keepdim=True)
    A = Gamma  # Gamma + ridge, in place
    if A.ndim == 3 and A.device.type == "cpu":
        # one matrix at a time: the CPU's batched LU of matrices this large
        # (MKL getrf inside ATen's parallel loop) can stall once the
        # process has changed its thread count
        phi = torch.stack([torch.linalg.solve(a, h) for a, h in zip(A, H)])
    else:
        phi = torch.linalg.solve(A, H[..., None])[..., 0]
    return phi, A, C, S


def _coupling(lay, phi):
    """(phi blocks (..., npairs, q), kappa, partial PLV I1(kappa)/I0(kappa))."""
    blocks = torch.as_tensor(_pair_blocks(lay), device=phi.device)
    phi_b = phi[..., blocks]
    kappa = torch.linalg.vector_norm(phi_b, dim=-1)
    return phi_b, kappa, torch.special.i1e(kappa) / torch.special.i0e(kappa)


def _check_sel_mode(sel_mode):
    if not (sel_mode[1] or sel_mode[2]):
        raise ValueError("need pairwise terms: sel_mode[1] or sel_mode[2]")


def torus_graph_fit(X, sel_mode=(False, True, False), alpha=0.05,
                    device=config.DEFAULT_DEVICE) -> TorusGraphResult:
    """Score-matching fit of a torus graph to phases X (d, n) in radians, on
    ``device``.

    Mirrors the used surface of ``pyTG.torusGraphs``: coefficient vector,
    sandwich covariance, per-edge p-values, conditional coupling (partial
    PLV), Bonferroni graph; tensors on ``device``.
    """
    _check_sel_mode(sel_mode)
    X = config.on_device(X, device)
    d, n = X.shape
    lay = layout(d, sel_mode)
    nodes = _node_index(lay, X.device)
    phi, A, C, S = _solve_phi(lay, nodes, X)

    # sandwich covariance: g_i = gradS_i score_i - c*S_i ; V = mean g g^T,
    # gradS_i score_i accumulated per node (the same restriction)
    score = _score(nodes, C, phi)  # (d, n)
    Gphi = torch.zeros((lay.m, n), dtype=X.dtype, device=X.device)
    Gphi.index_put_((nodes.stat.reshape(-1),), (C * score[:, None, :]).reshape(-1, n),
                    accumulate=True)
    g = Gphi - _c_vector(lay, X)[:, None] * S  # (m, n)
    V = (g @ g.T) / n
    Ginv = torch.linalg.solve(A, torch.eye(lay.m, dtype=X.dtype, device=X.device))
    phi_cov = Ginv @ V @ Ginv.T / n

    # per-edge Wald tests
    blocks = torch.as_tensor(_pair_blocks(lay), device=X.device)
    q = blocks.shape[1]
    phi_b, kappa, cond_coupling = _coupling(lay, phi)
    cov_b = phi_cov[blocks[:, :, None], blocks[:, None, :]]  # (npairs, q, q)
    sol = torch.linalg.solve(cov_b, phi_b[..., None])[..., 0]
    stat = torch.einsum("pq,pq->p", phi_b, sol)
    pvals = torch.special.gammaincc(torch.full_like(stat, q / 2.0),
                                    torch.clamp(stat, min=0.0) / 2.0)
    graph = pvals < (alpha / blocks.shape[0])
    return TorusGraphResult(
        phi=phi, phi_cov=phi_cov, pairs=lay.pairs, pvals=pvals,
        kappa=kappa, cond_coupling=cond_coupling, graph=graph,
    )


def torusGraphs(X, selMode=(False, True, False), device=config.DEFAULT_DEVICE):
    """pyTG-compatible call signature (``torus_graph_fit`` is the native API).

    Returns (graph, None, None, nodepairs, None, phi, phi_cov) as numpy
    arrays, with nodepairs = {'pVals', 'condCoupling', 'kappa', 'pairs'}:
    the surface the reference workloads consume (``torus_graph_fit.py:31-38``).
    """
    res = torus_graph_fit(X, sel_mode=tuple(selMode), device=device)
    nodepairs = {
        "pVals": res.pvals.cpu().numpy(),
        "condCoupling": res.cond_coupling.cpu().numpy(),
        "kappa": res.kappa.cpu().numpy(),
        "pairs": res.pairs,
    }
    return (
        res.graph.cpu().numpy(), None, None, nodepairs, None,
        res.phi.cpu().numpy(), res.phi_cov.cpu().numpy(),
    )


#: replicates per batched solve in :func:`bootstrap_partial_plv`.  At the
#: auditory size (d = 48, m = 2256) one replicate holds Gamma + ridge and
#: its LU factor, 2 x 40.7 MB, so 25 replicates hold ~2 GB of the card's
#: 80 GB (PERF.md gives the peak measured on an H100).
BOOT_BATCH = 25


def bootstrap_partial_plv(X, nboot, generator=None, indices=None,
                          sel_mode=(False, True, False), batch_size=BOOT_BATCH,
                          device=config.DEFAULT_DEVICE):
    """Trial bootstrap of the conditional coupling (partial PLV), batched.

    Replaces the reference's serial loops (``torus_graph_fit.py:49-58``,
    ``neuropixels/fit_torus_graph.py:51-59``).  Each replicate resamples the
    n trials with replacement and computes ``phi`` (one batched solve of
    Gamma + ridge per ``batch_size`` replicates) and its partial PLV, the
    same numbers as ``torus_graph_fit(X[:, idx]).cond_coupling``.

    :param X: (d, n) phases in radians.
    :param indices: (nboot, n) trial indices of the replicates; when None
        they are drawn by ``torch.randint`` from ``generator`` (a CPU
        ``torch.Generator``; a fresh one seeded 0 when None).
    :return: (npairs, nboot) tensor on ``device``.
    """
    _check_sel_mode(sel_mode)
    X = config.on_device(X, device)
    d, n = X.shape
    if indices is None:
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        indices = torch.randint(0, n, (nboot, n), generator=gen)
    indices = torch.as_tensor(indices, dtype=torch.long).to(X.device)
    if tuple(indices.shape) != (nboot, n):
        raise ValueError(f"indices must have shape {(nboot, n)}, got {tuple(indices.shape)}")
    lay = layout(d, sel_mode)
    nodes = _node_index(lay, X.device)
    out = []
    for i in range(0, nboot, batch_size):
        Xb = X[:, indices[i : i + batch_size]].movedim(1, 0)  # (b, d, n)
        phi = _solve_phi(lay, nodes, Xb)[0]
        out.append(_coupling(lay, phi)[2])
    return torch.cat(out, dim=0).T


def gibbs_sample(phi, d, n, seed=0, sel_mode=(False, True, False), burnin=200, thin=2):
    """Host-side Gibbs sampler from a torus graph (von Mises full
    conditionals), numpy, the JAX package's draws for the same seed:
    generative utility for simulation studies and tests.  Returns (d, n)
    angles in radians.
    """
    lay = layout(d, sel_mode)
    phi = np.asarray(phi)
    npairs = lay.pairs.shape[0]
    # unpack into dense coupling matrices
    eta_c = np.zeros(d)
    eta_s = np.zeros(d)
    a_c = np.zeros((d, d))  # cos-difference couplings (symmetric)
    a_s = np.zeros((d, d))  # sin-difference couplings (antisymmetric)
    b_c = np.zeros((d, d))  # cos-sum couplings (symmetric)
    b_s = np.zeros((d, d))  # sin-sum couplings (symmetric)
    if lay.sel_mode[0]:
        eta_c = phi[lay.marg_off : lay.marg_off + d]
        eta_s = phi[lay.marg_off + d : lay.marg_off + 2 * d]
    for p, (j, k) in enumerate(lay.pairs):
        if lay.sel_mode[1]:
            a_c[j, k] = a_c[k, j] = phi[lay.diff_off + p]
            a_s[j, k] = phi[lay.diff_off + npairs + p]
            a_s[k, j] = -phi[lay.diff_off + npairs + p]
        if lay.sel_mode[2]:
            b_c[j, k] = b_c[k, j] = phi[lay.sum_off + p]
            b_s[j, k] = b_s[k, j] = phi[lay.sum_off + npairs + p]

    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 2 * np.pi, size=d)
    out = np.empty((d, n))
    total = burnin + n * thin
    kept = 0
    for it in range(total):
        for j in range(d):
            cosx = np.cos(x)
            sinx = np.sin(x)
            # p(x_j | rest) ∝ exp(a cos x_j + b sin x_j)
            a = eta_c[j] + a_c[j] @ cosx - a_s[j] @ sinx + b_c[j] @ cosx + b_s[j] @ sinx
            bb = eta_s[j] + a_c[j] @ sinx + a_s[j] @ cosx - b_c[j] @ sinx + b_s[j] @ cosx
            # remove self terms (diagonals are zero by construction)
            kappa = np.hypot(a, bb)
            mu = np.arctan2(bb, a)
            x[j] = rng.vonmises(mu, kappa) % (2 * np.pi)
        if it >= burnin and (it - burnin) % thin == 0:
            out[:, kept] = x
            kept += 1
            if kept == n:
                break
    return out
