"""Grid helpers (numpy, host-side), copied from ``gpcsd_tpu.utils.grids``.

The port cannot import the JAX package: importing any of its modules runs
``gpcsd_tpu/__init__`` and therefore JAX.
"""

from __future__ import annotations

import numpy as np


def normalize(x):
    """Scale an (nx, nt, ...) array by its max absolute value over axes (0, 1)."""
    return x / np.max(np.abs(x), axis=(0, 1))


def sort_grid(x):
    """Lexicographically sort an (n, 2) point array by column 0 then column 1."""
    x = np.asarray(x)
    order = np.lexsort((x[:, 1], x[:, 0]))
    return x[order]


def expand_grid(x1, x2):
    """Tensor-product grid: all (a, b) pairs, a in x1 (outer), b in x2 (inner).

    Returns an (len(x1)*len(x2), 2) array ordered with x2 fastest, matching
    the reference ``expand_grid`` (list-comprehension order).
    """
    x1 = np.asarray(x1).reshape(-1)
    x2 = np.asarray(x2).reshape(-1)
    a = np.repeat(x1, x2.size)
    b = np.tile(x2, x1.size)
    return np.stack([a, b], axis=1)


def reduce_grid(x):
    """Inverse of :func:`expand_grid`: unique sorted values per column."""
    x = np.asarray(x)
    return np.sort(np.unique(x[:, 0])), np.sort(np.unique(x[:, 1]))
