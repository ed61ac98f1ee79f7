"""The port's CUDA kernel library: every ``csrc/*.cu`` in one ``nvcc`` call.

``csrc/quadform.cu`` (the quadratic form) and ``csrc/eigh_jacobi.cu`` (the
batched eigensolver) are compiled together into one shared library with a
plain C interface, loaded with ctypes, so that a checkout without a build
pays for one ``nvcc`` run.  The library is keyed on a hash of the sources
and the flags and lives in ``gpcsd_tpu_torch/_build/``; the compiler's
output (``-Xptxas -v``: registers, shared memory, spills) is kept beside it
as ``<library>.log``.  Importing this module needs no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SOURCES = (_PKG / "csrc" / "quadform.cu", _PKG / "csrc" / "eigh_jacobi.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): under
    ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``), else on PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cand.exists():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: set CUDA_HOME or put it on PATH")
    return found


def build() -> Path:
    """Compile the sources unless a library for these exact sources and
    flags exists; returns the library path."""
    key = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES) + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libgpcsd_kernels_{key.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [cuda_tool(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {[s.name for s in SOURCES]}:\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The library, built at first use and loaded once; each kernel's
    wrapper declares its own entry points' argument types."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
