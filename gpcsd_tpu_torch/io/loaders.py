"""LFP data loaders: the native text parser with a numpy fallback;
counterpart of ``gpcsd_tpu.io.loaders``.

Drop-in replacements for the reference's per-file ``np.loadtxt`` loops
(``auditory_lfp/fit_gpcsd_baseline.py:59-62``), backed by the C++ parser in
:mod:`gpcsd_tpu_torch.native` (mmap + strtod, one thread per file).  They
return numpy arrays on the host; callers move them to the device.
"""

from __future__ import annotations

import ctypes
import json
import os

import numpy as np

from ..native import lib as _native_lib


def loadtxt_matrix(path):
    """Load a whitespace-delimited numeric matrix (native, numpy fallback)."""
    L = _native_lib()
    if L is None:
        return np.loadtxt(path)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    if L.fastio_count(path.encode(), ctypes.byref(rows), ctypes.byref(cols)) != 0:
        raise FileNotFoundError(path)
    r, c = rows.value, cols.value
    out = np.empty((r, c), dtype=np.float64)
    got = L.fastio_load(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), r, c
    )
    if got != r * c:
        return np.loadtxt(path)  # ragged/odd file: defer to numpy semantics
    return out


def _cached_stack(cache_path, paths, meta):
    """The cached (N, rows, cols) array when its sidecar pins exactly
    ``meta`` and the cache is strictly newer than every source, else None."""
    if not (cache_path and os.path.exists(cache_path)):
        return None
    try:
        # strict > so a source rewritten within mtime granularity of the
        # cache write is never served stale; the sidecar pins the exact
        # path list + sizes so a different same-length set can't alias
        with open(cache_path + ".meta.json") as f:
            if json.load(f) != meta:
                return None
        if os.path.getmtime(cache_path) <= max(os.path.getmtime(p) for p in paths):
            return None
        arr = np.load(cache_path)
    except (OSError, ValueError, KeyError):
        return None
    return arr if arr.ndim == 3 and arr.shape[0] == len(paths) else None


def _write_cache(cache_path, arr, meta):
    """Write the array and its sidecar, each atomically."""
    try:
        tmp = cache_path + ".tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, cache_path)
        tmp_meta = cache_path + ".meta.json.tmp"
        with open(tmp_meta, "w") as f:
            json.dump(meta, f)
        os.replace(tmp_meta, cache_path + ".meta.json")
    except OSError:
        pass  # unwritable cache location: stay functional


def load_electrode_stack(paths, n_threads=0, cache_path=None):
    """Load N same-shaped text matrices into an (N, rows, cols) array, files
    parsed in parallel by the native runtime.

    :param cache_path: optional ``.npy`` binary cache, written after the
        first parse (atomically, with a ``.meta.json`` sidecar keying the
        exact path list and per-file sizes) and reused on later calls when
        strictly newer than every source file.
    """
    paths = list(paths)
    meta = {"paths": paths, "sizes": [os.path.getsize(p) for p in paths]} if cache_path else None
    cached = _cached_stack(cache_path, paths, meta)
    if cached is not None:
        return cached
    L = _native_lib()
    if L is None:
        return np.stack([np.loadtxt(p) for p in paths])
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    if L.fastio_count(paths[0].encode(), ctypes.byref(rows), ctypes.byref(cols)) != 0:
        raise FileNotFoundError(paths[0])
    r, c = rows.value, cols.value
    out = np.empty((len(paths), r, c), dtype=np.float64)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    ok = L.fastio_load_many(
        arr, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        r, c, n_threads,
    )
    if ok != len(paths):
        out = np.stack([np.loadtxt(p) for p in paths])
    if cache_path:
        _write_cache(cache_path, out, meta)
    return out


def load_auditory_probe(data_dir, probe, n_electrodes=24, cache=True,
                        demean=True):
    """Reference-format auditory probe: (nx, ntime, ntrials) LFP /100 plus
    the time vector in ms.

    :param demean: subtract the across-trial mean (the baseline workload's
        convention, reference ``fit_gpcsd_baseline.py:64``).  The evoked-
        response pipeline models the trial mean itself and passes ``False``.
    """
    paths = [
        os.path.join(data_dir, f"{probe}_electrode{i + 1}.txt")
        for i in range(n_electrodes)
    ]
    cache_path = (
        os.path.join(data_dir, f".gpcsd_cache_{probe}.npy") if cache else None
    )
    lfp = load_electrode_stack(paths, cache_path=cache_path) / 100.0
    if demean:
        lfp -= lfp.mean(axis=2, keepdims=True)
    time = loadtxt_matrix(os.path.join(data_dir, "time.txt")).reshape(-1) * 1000.0
    return lfp, time
