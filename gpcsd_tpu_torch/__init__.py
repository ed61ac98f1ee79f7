"""gpcsd-tpu-torch: the GPCSD inference engine on PyTorch, for NVIDIA Hopper.

A port of the JAX package ``gpcsd_tpu`` (which stays the reference), module
for module: the quadrature covariances, the factored Kronecker marginal
likelihood with a hand-written CUDA kernel for its quadratic form, the
``GPCSD1D`` model and its scipy MAP fit.  Float64 on every device.  This
package imports neither JAX nor ``gpcsd_tpu``.
"""

from . import config  # noqa: F401
from .models.covariances import (
    GPCSD1DSpatialCovSE,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
)
from .models.gpcsd1d import GPCSD1D
from .models.priors import HalfNormal, InvGamma, Normal

__all__ = [
    "GPCSD1D",
    "GPCSD1DSpatialCovSE",
    "GPCSDTemporalCovSE",
    "GPCSDTemporalCovMatern",
    "InvGamma",
    "HalfNormal",
    "Normal",
]

__version__ = "0.1.0"
