"""Traditional (second-spatial-difference) CSD baselines, numpy, copied from
``gpcsd_tpu.models.trad``.

Parity target: the reference ``src/gpcsd/predict_csd.py:3-31``
(``predictcsd_trad_1d`` / ``predictcsd_trad_2d``).  Vectorized: the Python
loops become slicing; edges are zero (1D) / NaN (2D) exactly as in the
reference.
"""

from __future__ import annotations

import numpy as np


def predictcsd_trad_1d(lfp):
    """Negative second spatial difference along axis 0.

    :param lfp: (nx, nt, ntrials)
    :return: (nx, nt, ntrials) CSD estimate; first/last channels zero
    """
    lfp = np.asarray(lfp)
    csd = np.zeros_like(lfp)
    csd[1:-1] = lfp[2:] + lfp[:-2] - 2.0 * lfp[1:-1]
    return -csd


def predictcsd_trad_2d(lfp):
    """Columnwise negative second difference for gridded 2D probes.

    :param lfp: (nx1, nx2, nt, ntrials)
    :return: same shape; column edges NaN (matching the reference)
    """
    lfp = np.asarray(lfp)
    csd = np.nan * np.ones_like(lfp)
    csd[:, 1:-1] = lfp[:, 2:] + lfp[:, :-2] - 2.0 * lfp[:, 1:-1]
    return -csd
