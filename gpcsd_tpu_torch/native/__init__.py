"""Native (C++) text parser for the loaders, bound with ctypes; counterpart
of ``gpcsd_tpu.native``.

``fastio.cpp`` is compiled with g++ at first use into
``gpcsd_tpu_torch/_build/``, under a name keyed on a hash of the source and
the flags, so a source edit rebuilds and a library is never taken for
another source.  The flags leave out ``-march=native``: a library built on
one host must load on another.  Host I/O only: every caller tolerates
``lib() is None`` and falls back to numpy, since the native path is an
accelerator, not a dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "fastio.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library for this exact source and flag set lives."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfastio_{key.hexdigest()[:16]}.so"


def compiler_version() -> str:
    """The first line of ``g++ --version``, or "" without a compiler."""
    try:
        out = subprocess.run([CXX, "--version"], capture_output=True, text=True, timeout=30)
    except OSError:
        return ""
    return out.stdout.splitlines()[0] if out.returncode == 0 and out.stdout else ""


def build() -> Path:
    """Compile ``fastio.cpp`` unless the library for this source exists;
    returns its path, raises ``RuntimeError`` when the compiler fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{CXX} failed on {SOURCE}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def lib():
    """The loaded ctypes library, or None if it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            L = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError):
            return None
        i64, dbl_p = ctypes.c_int64, ctypes.POINTER(ctypes.c_double)
        L.fastio_count.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64)]
        L.fastio_count.restype = ctypes.c_int
        L.fastio_load.argtypes = [ctypes.c_char_p, dbl_p, i64, i64]
        L.fastio_load.restype = i64
        L.fastio_load_many.argtypes = [ctypes.POINTER(ctypes.c_char_p), i64, dbl_p, i64, i64, i64]
        L.fastio_load_many.restype = i64
        _lib = L
        return _lib
