"""Fused Kronecker-whitened quadratic form: CUDA kernel, plain version, autograd.

    quadform(qs, qt, dinv, Y) = sum_b sum_ij (Qs^T Y_b Qt)_ij^2 * dinv_ij
    quadform_rows(qs, qt, dinv, Y)[b] = sum_ij (Qs^T Y_b Qt)_ij^2 * dinv_ij

Counterpart of the Pallas TPU kernel ``gpcsd_tpu/ops/pallas/quadform.py``
(``_quadform_kernel``).  The kernel is ``gpcsd_tpu_torch/csrc/quadform.cu``
(float64, sm_90a; its header says what bounds it and how it is laid out),
compiled with ``nvcc`` at first use into the port's one kernel library
(:mod:`gpcsd_tpu_torch.ops.cuda.library`) and bound with ctypes.
Importing this module needs no ``nvcc``.

On a CPU tensor :func:`quadform` computes :func:`quadform_reference`; on a
CUDA tensor it launches the kernel or raises.  The backward recomputes the
whitened array with ``torch.matmul`` (the TPU kernel had no backward; JAX
differentiated the einsum path).  :func:`quadform_rows` is the per-trial
output of the same kernel (another GEMM epilogue in the same source), for
callers whose rows share ``(qs, qt, dinv)`` and need one value each, as
the shift stage's batched trials do; its launches are counted apart.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.profiling import span
from .library import load as _load_library

#: Kernel launches since import (or since a caller reset it to 0); the
#: wrapper adds one per launch of the CUDA kernel and nowhere else.
launch_count = 0
#: The same launches by shape ``(nx, nt, ntrials)`` (a caller may clear it).
launches_by_shape: dict = {}
#: Launches of the per-trial kernel (:func:`quadform_rows_cuda`), counted as
#: :data:`launch_count` is but apart from it, and by shape.
rows_launch_count = 0
rows_launches_by_shape: dict = {}

_lib = None
_ready_devices: set[int] = set()  # devices where quadform_f64_init ran


def _load():
    global _lib
    if _lib is None:
        lib = _load_library()
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quadform_f64_init.argtypes = []
        lib.quadform_f64_init.restype = i32
        lib.quadform_f64_workspace.argtypes = [i32] * 3
        lib.quadform_f64_workspace.restype = i64
        lib.quadform_rows_f64_workspace.argtypes = [i32] * 3
        lib.quadform_rows_f64_workspace.restype = i64
        for entry in (lib.quadform_f64, lib.quadform_rows_f64):
            entry.argtypes = [ptr] * 5 + [i64, ptr] + [i32] * 3 + [ptr]
            entry.restype = i32
        lib.quadform_error_string.argtypes = [ctypes.c_int]
        lib.quadform_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.quadform_error_string(err).decode()
        raise RuntimeError(f"quadform kernel {what} failed: {msg}")


def _check(qs, qt, dinv, Y):
    if Y.ndim != 3:
        raise ValueError(f"Y must be (ntrials, nx, nt), got shape {tuple(Y.shape)}")
    _, nx, nt = Y.shape
    for name, t, shape in (("qs", qs, (nx, nx)), ("qt", qt, (nt, nt)), ("dinv", dinv, (nx, nt))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    for name, t in (("qs", qs), ("qt", qt), ("dinv", dinv), ("Y", Y)):
        if t.device != Y.device:
            raise ValueError(f"{name} is on {t.device}, Y on {Y.device}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def quadform_reference(qs, qt, dinv, Y):
    """Plain PyTorch version: the whitening einsum and the weighted sum."""
    alpha = qs.mT @ Y @ qt
    return torch.sum(torch.square(alpha) * dinv)


def quadform_rows_reference(qs, qt, dinv, Y):
    """Plain PyTorch version of :func:`quadform_rows`: (ntrials,)."""
    return torch.sum(torch.square(qs.mT @ Y @ qt) * dinv, dim=(1, 2))


def _shape_key(Y):
    ntrials, nx, nt = Y.shape
    return (nx, nt, ntrials)


def _launch(entry, workspace, out_shape, qs, qt, dinv, Y):
    """Run one of the library's entry points on the current stream of Y's
    device (no synchronisation).  Allocates the kernels' scratch (the
    (ntrials*nx, nt) array ``Qs^T Y_b``, the partials, room for Qt at an
    even row stride) and the output with ``torch.empty``, so the call can
    be captured in a CUDA graph."""
    if Y.device.type != "cuda":
        raise ValueError(f"the quadform kernel needs CUDA tensors, got {Y.device}")
    lib = _load()
    ntrials, nx, nt = Y.shape
    work_elems = getattr(lib, workspace)(nx, nt, ntrials)
    if work_elems < 0:
        raise ValueError(f"quadform kernel does not take shape {tuple(Y.shape)}")
    work = torch.empty(work_elems, dtype=torch.float64, device=Y.device)
    out = torch.empty(out_shape, dtype=torch.float64, device=Y.device)
    with torch.cuda.device(Y.device):
        if Y.device.index not in _ready_devices:
            _raise_on(lib, lib.quadform_f64_init(), "set-up")
            _ready_devices.add(Y.device.index)
        err = getattr(lib, entry)(
            qs.data_ptr(), qt.data_ptr(), dinv.data_ptr(), Y.data_ptr(),
            work.data_ptr(), work_elems, out.data_ptr(), nx, nt, ntrials,
            torch.cuda.current_stream(Y.device).cuda_stream,
        )
    _raise_on(lib, err, "launch")
    return out


def quadform_cuda(qs, qt, dinv, Y):
    """Launch the CUDA kernels for :func:`quadform` (a 0-d tensor); inputs
    as :func:`quadform` checks them.  Capturable in a CUDA graph."""
    global launch_count
    out = _launch("quadform_f64", "quadform_f64_workspace", (), qs, qt, dinv, Y)
    launch_count += 1
    shape = _shape_key(Y)
    launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
    return out


def quadform_rows_cuda(qs, qt, dinv, Y):
    """Launch the CUDA kernels for :func:`quadform_rows` (an (ntrials,)
    tensor); inputs as :func:`quadform` checks them.  Capturable in a CUDA
    graph.  Counted in :data:`rows_launch_count`."""
    global rows_launch_count
    out = _launch("quadform_rows_f64", "quadform_rows_f64_workspace", (Y.shape[0],),
                  qs, qt, dinv, Y)
    rows_launch_count += 1
    shape = _shape_key(Y)
    rows_launches_by_shape[shape] = rows_launches_by_shape.get(shape, 0) + 1
    return out


class QuadForm(torch.autograd.Function):
    """With ``alpha_b = Qs^T Y_b Qt`` and ``G_b = dinv o alpha_b``:
    d/dQs = 2 sum_b Y_b Qt G_b^T, d/dQt = 2 sum_b Y_b^T Qs G_b,
    d/ddinv = sum_b alpha_b^2, d/dY_b = 2 Qs G_b Qt^T."""

    @staticmethod
    def forward(ctx, qs, qt, dinv, Y):
        ctx.save_for_backward(qs, qt, dinv, Y)
        if Y.device.type == "cpu":
            return quadform_reference(qs, qt, dinv, Y)
        return quadform_cuda(qs, qt, dinv, Y)

    @staticmethod
    def backward(ctx, grad):
        with span("gpcsd.quadform.backward"):
            qs, qt, dinv, Y = ctx.saved_tensors
            need_qs, need_qt, need_dinv, need_y = ctx.needs_input_grad
            y_qt = Y @ qt  # (B, nx, nt)
            alpha = qs.mT @ y_qt
            G = dinv * alpha
            g_qs = g_qt = g_dinv = g_y = None
            if need_qs:
                g_qs = 2.0 * grad * torch.tensordot(y_qt, G, dims=([0, 2], [0, 2]))
            if need_qt:
                g_qt = 2.0 * grad * torch.tensordot(qs.mT @ Y, G, dims=([0, 1], [0, 1]))
            if need_dinv:
                g_dinv = grad * torch.sum(torch.square(alpha), dim=0)
            if need_y:
                g_y = 2.0 * grad * (qs @ G @ qt.mT)
        return g_qs, g_qt, g_dinv, g_y


class QuadFormRows(torch.autograd.Function):
    """:class:`QuadForm` with one output per trial: for a cotangent ``g``
    of shape (ntrials,), every trial's term of each gradient is weighted
    by ``g_b``; d/dY_b = 2 g_b Qs G_b Qt^T."""

    @staticmethod
    def forward(ctx, qs, qt, dinv, Y):
        ctx.save_for_backward(qs, qt, dinv, Y)
        if Y.device.type == "cpu":
            return quadform_rows_reference(qs, qt, dinv, Y)
        return quadform_rows_cuda(qs, qt, dinv, Y)

    @staticmethod
    def backward(ctx, grad):
        with span("gpcsd.quadform.backward"):
            qs, qt, dinv, Y = ctx.saved_tensors
            need_qs, need_qt, need_dinv, need_y = ctx.needs_input_grad
            y_qt = Y @ qt  # (B, nx, nt)
            alpha = qs.mT @ y_qt
            w = grad[:, None, None]
            Gw = w * (dinv * alpha)  # g_b G_b
            g_qs = g_qt = g_dinv = g_y = None
            if need_qs:
                g_qs = 2.0 * torch.tensordot(y_qt, Gw, dims=([0, 2], [0, 2]))
            if need_qt:
                g_qt = 2.0 * torch.tensordot(qs.mT @ Y, Gw, dims=([0, 1], [0, 1]))
            if need_dinv:
                g_dinv = torch.sum(w * torch.square(alpha), dim=0)
            if need_y:
                g_y = 2.0 * (qs @ Gw @ qt.mT)
        return g_qs, g_qt, g_dinv, g_y


def quadform(qs, qt, dinv, Y):
    """``sum_b sum_ij (Qs^T Y_b Qt)_ij^2 * dinv_ij``, differentiable.

    :param qs: (nx, nx); :param qt: (nt, nt); :param dinv: (nx, nt)
    :param Y: (ntrials, nx, nt).  All float64, contiguous, on one device.
    """
    _check(qs, qt, dinv, Y)
    return QuadForm.apply(qs, qt, dinv, Y)


def quadform_rows(qs, qt, dinv, Y):
    """``sum_ij (Qs^T Y_b Qt)_ij^2 * dinv_ij`` for every trial b, an
    (ntrials,) tensor, differentiable: one kernel launch for all trials.
    Arguments as :func:`quadform`."""
    _check(qs, qt, dinv, Y)
    return QuadFormRows.apply(qs, qt, dinv, Y)
