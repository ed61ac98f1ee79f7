"""Grid helpers (numpy, host-side), copied from ``gpcsd_tpu.utils.grids``.

The port cannot import the JAX package: importing any of its modules runs
``gpcsd_tpu/__init__`` and therefore JAX.
"""

from __future__ import annotations

import numpy as np


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
