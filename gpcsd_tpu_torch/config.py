"""Numeric constants and device selection for the PyTorch port.

The port works in float64 on every device: the quadrature Gram matrix at
ngl=100 is ill-conditioned and the likelihood's log-determinant is taken
with noise variances as small as 1e-8 (reference ``gpcsd1d.py:117-123``).
The H100 runs float64 natively, so there is no mixed-precision policy.
"""

from __future__ import annotations

import numpy as np
import torch

#: Working dtype of every covariance, factorization and contraction.
DTYPE = torch.float64

#: Diagonal jitter added to spatial covariances, matching the reference
#: (``gpcsd1d.py:17`` and ``gpcsd2d.py:16``).
JITTER_1D = 1e-8
JITTER_2D = 1e-7

#: Where every entry point of the package runs unless its caller passes
#: ``device=``: the card.  The CPU is used only when asked for by name.
DEFAULT_DEVICE = "cuda"


def get_device(name=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``name``; raises when CUDA is asked for and
    absent.  It never falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    return dev


def on_device(x, device=DEFAULT_DEVICE, dtype=DTYPE) -> torch.Tensor:
    """``x`` (a tensor, numpy array or number) as a ``dtype`` tensor on
    ``device``, through :func:`get_device`; a tensor already there is
    returned as it is."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x, dtype=dtype, device=get_device(device))
