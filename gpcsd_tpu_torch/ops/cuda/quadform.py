"""Fused Kronecker-whitened quadratic form: CUDA kernel, plain version, autograd.

    quadform(qs, qt, dinv, Y) = sum_b sum_ij (Qs^T Y_b Qt)_ij^2 * dinv_ij

Counterpart of the Pallas TPU kernel ``gpcsd_tpu/ops/pallas/quadform.py``
(``_quadform_kernel``).  The kernel is ``gpcsd_tpu_torch/csrc/quadform.cu``
(float64, sm_90a; its header says what bounds it and how it is laid out),
compiled with ``nvcc`` into a shared library at first use and bound with
ctypes.  The library is keyed on a hash of the source and flags and lives
in ``gpcsd_tpu_torch/_build/``.  Importing this module needs no ``nvcc``.

On a CPU tensor :func:`quadform` computes :func:`quadform_reference`; on a
CUDA tensor it launches the kernel or raises.  The backward recomputes the
whitened array with ``torch.matmul`` (the TPU kernel had no backward; JAX
differentiated the einsum path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "quadform.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Kernel launches since import (or since a caller reset it to 0); the
#: wrapper adds one per launch of the CUDA kernel and nowhere else.
launch_count = 0

_lib = None


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Path:
    """Compile ``csrc/quadform.cu`` unless a library for this exact source
    and flag set exists; returns the library path.  The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside it as
    ``<library>.log``."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libquadform_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.quadform_f64.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p
        ]
        lib.quadform_f64.restype = ctypes.c_int
        lib.quadform_f64_num_blocks.argtypes = [ctypes.c_int] * 3
        lib.quadform_f64_num_blocks.restype = ctypes.c_int
        lib.quadform_f64_max_nx.argtypes = []
        lib.quadform_f64_max_nx.restype = ctypes.c_int
        lib.quadform_error_string.argtypes = [ctypes.c_int]
        lib.quadform_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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


def quadform_cuda(qs, qt, dinv, Y):
    """Launch the CUDA kernel on the current stream of Y's device (no
    synchronisation); inputs as :func:`quadform` checks them."""
    global launch_count
    if Y.device.type != "cuda":
        raise ValueError(f"quadform_cuda needs CUDA tensors, got {Y.device}")
    lib = _load()
    ntrials, nx, nt = Y.shape
    max_nx = lib.quadform_f64_max_nx()
    if nx > max_nx:
        raise ValueError(f"nx={nx} exceeds the kernel's shared-memory limit nx<={max_nx}")
    nblocks = lib.quadform_f64_num_blocks(nx, nt, ntrials)
    partials = torch.empty(nblocks, dtype=torch.float64, device=Y.device)
    out = torch.empty((), dtype=torch.float64, device=Y.device)
    with torch.cuda.device(Y.device):
        err = lib.quadform_f64(
            qs.data_ptr(), qt.data_ptr(), dinv.data_ptr(), Y.data_ptr(),
            partials.data_ptr(), out.data_ptr(), nx, nt, ntrials,
            torch.cuda.current_stream(Y.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"quadform kernel launch failed: {lib.quadform_error_string(err).decode()}"
        )
    launch_count += 1
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


def quadform(qs, qt, dinv, Y):
    """``sum_b sum_ij (Qs^T Y_b Qt)_ij^2 * dinv_ij``, differentiable.

    :param qs: (nx, nx); :param qt: (nt, nt); :param dinv: (nx, nt)
    :param Y: (ntrials, nx, nt).  All float64, contiguous, on one device.
    """
    _check(qs, qt, dinv, Y)
    return QuadForm.apply(qs, qt, dinv, Y)
