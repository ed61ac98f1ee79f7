"""Batched symmetric eigendecomposition on the card: block Jacobi in the DCT basis.

    w, V = eigh_jacobi_cuda(A)   # A (C, n, n) float64 symmetric; as torch.linalg.eigh

All C matrices are solved by one launch of ``csrc/eigh_jacobi.cu`` (a
thread-block cluster each; its header says what bounds it and how), and
nothing is read back to the host, so a call can be captured in a CUDA
graph.  It replaces no Pallas kernel: the JAX package's TPU route is the
block Jacobi of ``gpcsd_tpu/ops/jacobi.py`` (``_eigh_block_jacobi``), and
this is its counterpart redesigned for the H100, where the port called
cuSOLVER's ``syevd`` one matrix after another.

Around the kernel, in PyTorch (:func:`congruence`): ``B = P^T A P`` in the
DCT-II basis ``P`` (:func:`dct_basis`, a fixed
function of n: exact for any symmetric A, and it leaves a stationary
covariance on a uniform grid nearly diagonal, so the sweeps are few), padded
to a multiple of 32 with decoupled diagonal entries above B's Gershgorin
bound (they rank last and are dropped), and the tolerance ``eps * ||A||_F``;
after it, ``V = P W``.  The stopping rule is the JAX solver's (off-diagonal
norm at most the tolerance, or its stall exit); a matrix still above it
after :data:`MAX_SWEEPS` gets NaN eigenvalues and counts as unconverged.

:func:`eigh_jacobi_reference` is the same algorithm in plain PyTorch (the
CPU tests hold it to ``torch.linalg.eigh`` and the JAX solver; on the card
``chip_smoke.py`` holds the kernel to it).  Launches are counted in
:data:`launch_count` and by order in :data:`launches_by_order`; the
program's counter registry gets ``kronlik.jacobi.rows`` (matrices solved,
counted by the wrapper) and ``kronlik.jacobi.sweeps`` and ``kronlik.jacobi.unconverged`` (summed by the
kernel on the device, read only when the registry is read).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...utils import profiling
from .library import load as _load_library

BLOCK = 16             #: rows of a block of the block grid
TILE = 2 * BLOCK       #: rows of a pair problem; n is padded to a multiple of it
MAX_SWEEPS = 30        #: sweeps of a matrix, at most
EPS = torch.finfo(torch.float64).eps

#: Kernel launches since import (or since a caller reset it to 0).
launch_count = 0
#: The same by the order n of the matrices launched (a caller may clear it).
launches_by_order: dict[int, int] = {}

_lib = None
_ready_devices: set[int] = set()
_active: dict = {}  # (device, cluster) -> clusters the device runs at once
_bases: dict = {}   # (n, device) -> the DCT basis
_schedules: dict = {}  # (n, device) -> the plain version's inner steps


def _load():
    global _lib
    if _lib is None:
        lib = _load_library()
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("eigh_jacobi_f64_init", "eigh_jacobi_f64_max_cluster"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        lib.eigh_jacobi_f64_active_clusters.argtypes = [i32]
        lib.eigh_jacobi_f64_active_clusters.restype = i32
        lib.eigh_jacobi_f64.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.eigh_jacobi_f64.restype = i32
        lib.eigh_jacobi_f64_stats.argtypes = [ptr, i32]
        lib.eigh_jacobi_f64_stats.restype = i32
        lib.eigh_jacobi_error_string.argtypes = [i32]
        lib.eigh_jacobi_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.eigh_jacobi_error_string(err).decode()
        raise RuntimeError(f"eigh_jacobi kernel {what} failed: {msg}")


def _index(device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def _ready(device) -> ctypes.CDLL:
    """The library, initialised on ``device``."""
    lib = _load()
    if _index(device) not in _ready_devices:
        with torch.cuda.device(device):
            _raise_on(lib, lib.eigh_jacobi_f64_init(), "set-up")
        _ready_devices.add(_index(device))
    return lib


def padded_order(n: int) -> int:
    """The order the kernel pads a matrix of order n to: a multiple of 32."""
    return -(-n // TILE) * TILE


def dct_basis(n: int, dtype=torch.float64, device=None):
    """The orthonormal DCT-II basis ``P`` (n, n), ``P[j, k] =
    cos(pi (2j + 1) k / 2n) sqrt(2/n)``, column 0 divided by sqrt(2):
    ``gpcsd_tpu.ops.kronlik.dct_basis``.  A stationary covariance on a
    uniform grid is nearly Toeplitz, which the DCT nearly diagonalizes, so
    the solver starts in this basis; for any symmetric matrix it is an exact
    orthogonal congruence."""
    j = torch.arange(n, dtype=dtype, device=device)[:, None]
    k = torch.arange(n, dtype=dtype, device=device)[None, :]
    P = torch.cos(math.pi * (2.0 * j + 1.0) * k / (2.0 * n)) * math.sqrt(2.0 / n)
    P[:, 0] /= math.sqrt(2.0)
    return P


def _basis(n, like):
    """The DCT basis of order n on ``like``'s device, kept per device outside
    a CUDA-graph capture (a tensor made inside one holds its values only
    once the graph replays)."""
    key = (n, like.device)
    if key in _bases:
        return _bases[key]
    P = dct_basis(n, dtype=like.dtype, device=like.device)
    if not (like.is_cuda and torch.cuda.is_current_stream_capturing()):
        _bases[key] = P
    return P


def congruence(a):
    """``(B, tol, P)`` for a batch ``a`` (C, n, n): ``B = P^T a P`` made
    exactly symmetric and padded to (C, npad, npad) with decoupled diagonal
    entries ``big * (1 + 0.01 k)``, ``big = 1.05 * max row sum |B| + 1``
    (``gpcsd_tpu.ops.jacobi._pad_decoupled``); ``tol = eps * ||a||_F``, of
    the unpadded matrix, per row."""
    n = a.shape[-1]
    P = _basis(n, a)
    b = P.mT @ a @ P
    b = 0.5 * (b + b.mT)
    npad = padded_order(n)
    tol = EPS * torch.linalg.matrix_norm(a)
    if npad == n:
        return b.contiguous(), tol, P
    big = 1.05 * b.abs().sum(dim=-1).amax(dim=-1) + 1.0
    out = torch.zeros(a.shape[0], npad, npad, dtype=a.dtype, device=a.device)
    out[:, :n, :n] = b
    extra = 1.0 + 0.01 * torch.arange(npad - n, dtype=a.dtype, device=a.device)
    out[:, n:, n:] = torch.diag_embed(big[:, None] * extra)
    return out, tol, P


def _round_pair(players, r, k):
    """The circle schedule over ``players`` indices: the k-th pair of round r
    (``round_pair`` in the kernel)."""
    last = players - 1
    if k == 0:
        return r, last
    return (r + k) % last, (r - k + last) % last


def _pair_index(I, J, device):
    """Indices in B of the rows of the pair tile of blocks (I, J)."""
    ar = torch.arange(BLOCK, device=device)
    return torch.cat([I * BLOCK + ar, J * BLOCK + ar])


def _exceeds(apq, app, aqq, thr):
    return apq.abs() > torch.clamp(EPS * (app.abs() + aqq.abs()), min=thr)


def _inner_schedule(n, device):
    """The inner steps of a pair problem of order n: ``(p, q, upper)`` per
    step, its pairs' two index tensors and the mask of the entries (i, j)
    whose pair comes before j's (the kernel computes those and mirrors)."""
    key = (n, device)
    if key not in _schedules:
        steps = []
        for step in range(n - 1):
            pq = torch.tensor([_round_pair(n, step, k) for k in range(n // 2)], device=device)
            pair_of = torch.empty(n, dtype=torch.long, device=device)
            pair_of[pq[:, 0]] = pair_of[pq[:, 1]] = torch.arange(n // 2, device=device)
            steps.append((pq[:, 0], pq[:, 1], pair_of[:, None] < pair_of[None, :]))
        _schedules[key] = steps
    return _schedules[key]


def _solve_pair(S, thr):
    """One sweep of cyclic Jacobi on a 32 x 32 pair tile, as the kernel's
    ``solve_pair``: ``(S', Q, rotated)`` with ``S' = Q^T S Q``; none where no
    off-diagonal entry exceeds the threshold."""
    n = S.shape[-1]
    Q = torch.eye(n, dtype=S.dtype, device=S.device)
    iu, ju = torch.triu_indices(n, n, 1, device=S.device)
    d = S.diagonal()
    rotated = bool(_exceeds(S[iu, ju], d[iu], d[ju], thr).any())
    if rotated:
        for p, q, upper in _inner_schedule(n, S.device):
            app, aqq, apq = S[p, p], S[q, q], S[p, q]
            # sym.schur2 as the kernel's rotation(): t = es / u, c = u / sqrt(2hu),
            # s = es / sqrt(2hu), with d = aqq - app, e = 2 apq, h = |(d, e)|, u = |d| + h
            d, e = aqq - app, 2.0 * apq
            es = torch.where((d == 0.0) | ((d > 0.0) == (e > 0.0)), e.abs(), -e.abs())
            u = d.abs() + torch.sqrt(d * d + e * e)
            r = 1.0 / torch.sqrt(2.0 * (u - d.abs()) * u)
            ex = _exceeds(apq, app, aqq, thr)
            c = torch.where(ex, u * r, 1.0)
            s = torch.where(ex, es * r, 0.0)
            t = torch.where(ex, es / u, 0.0)
            # every 2x2 block rows first, then columns; those of a pair x
            # after pair y mirrored from the block (y, x); the diagonal
            # blocks by sym.schur2
            Sp, Sq = S[p].clone(), S[q].clone()
            S[p], S[q] = c[:, None] * Sp - s[:, None] * Sq, s[:, None] * Sp + c[:, None] * Sq
            Sp, Sq = S[:, p].clone(), S[:, q].clone()
            S[:, p], S[:, q] = Sp * c - Sq * s, Sp * s + Sq * c
            S = torch.where(upper, S, S.mT)
            rot = t != 0.0
            pr, qr, tr, apq_r = p[rot], q[rot], t[rot], apq[rot]
            S[pr, pr] = app[rot] - tr * apq_r
            S[qr, qr] = aqq[rot] + tr * apq_r
            S[pr, qr] = 0.0
            S[qr, pr] = 0.0
            Qp, Qq = Q[:, p].clone(), Q[:, q].clone()
            Q[:, p], Q[:, q] = Qp * c - Qq * s, Qp * s + Qq * c
    return S, Q, rotated


def _offnorm(B):
    return float(torch.linalg.matrix_norm(B - torch.diag_embed(B.diagonal())))


def _solve_row(b, n, tol):
    """The kernel's sweeps on one padded matrix: ``(w, W, sweeps,
    unconverged)``, W's columns and w ascending, rows and columns < n."""
    npad = b.shape[-1]
    nb = npad // BLOCK
    m = nb // 2
    B = b.clone()
    W = torch.eye(npad, dtype=b.dtype, device=b.device)
    thr = tol / npad
    off = _offnorm(B)
    sweeps = nstall = 0
    stalled = False
    while off > tol and not stalled and sweeps < MAX_SWEEPS:
        before = off
        for r in range(nb - 1):
            idx = [_pair_index(*_round_pair(nb, r, k), b.device) for k in range(m)]
            rotations = []
            for ix in idx:
                S, Q, rotated = _solve_pair(B[ix][:, ix].clone(), thr)
                if rotated:
                    B[ix[:, None], ix] = S
                rotations.append((Q, rotated))
            for k1 in range(m):
                for k2 in range(k1 + 1, m):
                    (q1, r1), (q2, r2) = rotations[k1], rotations[k2]
                    if r1 or r2:
                        i1, i2 = idx[k1], idx[k2]
                        Y = q1.mT @ (B[i1][:, i2] @ q2)
                        B[i1[:, None], i2] = Y
                        B[i2[:, None], i1] = Y.mT
            for ix, (Q, rotated) in zip(idx, rotations):
                if rotated:
                    W[:, ix] = W[:, ix] @ Q
        off = _offnorm(B)
        sweeps += 1
        nstall = nstall + 1 if off >= 0.9 * before else 0
        stalled = (nstall >= 1 and off < 10.0 * tol) or nstall >= 2
    unconverged = off > tol and not stalled
    d, order = torch.sort(B.diagonal(), stable=True)
    w = d[:n].clone()
    if unconverged:
        w.fill_(float("nan"))
    return w, W[:n][:, order[:n]], sweeps, unconverged


def eigh_jacobi_reference(a, info: dict | None = None):
    """Plain PyTorch version of :func:`eigh_jacobi_cuda`, one matrix after
    another: the same congruence, padding, schedule, thresholds and
    stopping rule.  ``info``, where given, gets ``"sweeps"`` and
    ``"unconverged"``, a list each."""
    b, tol, P = congruence(a)
    n = a.shape[-1]
    out = [_solve_row(bc, n, float(tc)) for bc, tc in zip(b, tol)]
    if info is not None:
        info["sweeps"] = [o[2] for o in out]
        info["unconverged"] = [o[3] for o in out]
    w = torch.stack([o[0] for o in out])
    return w, P @ torch.stack([o[1] for o in out])


def cluster_size(rows: int, n: int, device) -> int:
    """CTAs a matrix: the largest, up to one a pair of blocks and the
    device's largest cluster, at which the ``rows`` clusters run in one
    wave; 1 where none does."""
    lib = _ready(device)
    top = min(lib.eigh_jacobi_f64_max_cluster(), padded_order(n) // TILE)
    for k in range(top, 0, -1):
        key = (_index(device), k)
        if key not in _active:
            with torch.cuda.device(device):
                _active[key] = lib.eigh_jacobi_f64_active_clusters(k)
        if _active[key] >= rows:
            return k
    return 1


def _check(a):
    if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"A must be (C, n, n), got shape {tuple(a.shape)}")
    if a.dtype != torch.float64:
        raise TypeError(f"A must be float64, got {a.dtype}")
    if a.device.type != "cuda":
        raise ValueError(f"the eigh_jacobi kernel needs a CUDA tensor, got {a.device}")


def eigh_jacobi_cuda(a, cluster: int | None = None):
    """``(w, V)`` of every matrix of ``a`` (C, n, n) by one launch on the
    current stream; no host sync, capturable in a CUDA graph.

    :param cluster: CTAs a matrix (default :func:`cluster_size`)
    """
    global launch_count
    _check(a)
    rows, n = a.shape[0], a.shape[-1]
    b, tol, P = congruence(a)
    npad = b.shape[-1]
    lib = _ready(a.device)
    k = cluster or cluster_size(rows, n, a.device)
    like = dict(dtype=torch.float64, device=a.device)
    W = torch.empty_like(b)
    q = torch.empty(rows, npad // TILE, TILE, TILE, **like)
    rot = torch.empty(rows, npad // TILE, dtype=torch.int32, device=a.device)
    part = torch.empty(rows, 2, k, **like)
    w = torch.empty(rows, n, **like)
    v = torch.empty(rows, n, n, **like)
    with torch.cuda.device(a.device):
        err = lib.eigh_jacobi_f64(
            b.data_ptr(), W.data_ptr(), q.data_ptr(), rot.data_ptr(), part.data_ptr(),
            tol.data_ptr(), w.data_ptr(), v.data_ptr(), rows, n, npad, k, MAX_SWEEPS,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _raise_on(lib, err, "launch")
    launch_count += 1
    launches_by_order[n] = launches_by_order.get(n, 0) + 1
    profiling.count("kronlik.jacobi.rows", rows)
    return w, P @ v


def stats(reset: bool = False) -> dict:
    """The kernel's device counters summed over the devices it ran on:
    ``{"sweeps": ..., "unconverged": ...}`` (waits for those devices);
    ``reset`` sets them to 0."""
    total = {"sweeps": 0, "unconverged": 0}
    for index in sorted(_ready_devices):
        out = (ctypes.c_ulonglong * 2)()
        with torch.cuda.device(index):
            _raise_on(_lib, _lib.eigh_jacobi_f64_stats(out, int(reset)), "stats")
        total["sweeps"] += out[0]
        total["unconverged"] += out[1]
    return total


def _registry_counters(host: dict) -> dict:
    """The device counters under their registry names, read only when the
    kernel ran since the registry was last reset."""
    if not _ready_devices or "kronlik.jacobi.rows" not in host:
        return {}
    return {f"kronlik.jacobi.{k}": v for k, v in stats().items()}


def _reset_registry_counters():
    if _ready_devices:
        stats(reset=True)


profiling.add_counter_source(_registry_counters, _reset_registry_counters)
