"""gpcsd-tpu-torch: the GPCSD inference engine on PyTorch, for NVIDIA Hopper.

A port of the JAX package ``gpcsd_tpu`` (which stays the reference), module
for module: the quadrature covariances, the factored Kronecker marginal
likelihood with a hand-written CUDA kernel for its quadratic form, the
``GPCSD1D`` and ``GPCSD2D`` models with their MAP fit (L-BFGS batched over
restarts, or scipy), Laplace-whitened dense-metric NUTS posterior with
checkpoint/resume, mean-field ADVI, adaptive tempered SMC, WAIC and
PSIS-LOO, predictions, posterior variance and Matheron posterior samples,
and the paper-scale NUTS run (``paper_run``).  Float64 on every device, and
the card is the default device.  This package imports neither JAX nor ``gpcsd_tpu``.
"""

from . import config  # noqa: F401
from .models.covariances import (
    GPCSD1DSpatialCovSE,
    GPCSD2DSpatialCovSE,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
)
from .models.gpcsd1d import GPCSD1D
from .models.gpcsd2d import GPCSD2D
from .ops.forward import b_fwd_2d, fwd_model_1d, fwd_model_2d, fwd_operator_2d
from .models.priors import HalfNormal, InvGamma, Normal

__all__ = [
    "GPCSD1D",
    "GPCSD2D",
    "GPCSD1DSpatialCovSE",
    "GPCSD2DSpatialCovSE",
    "GPCSDTemporalCovSE",
    "GPCSDTemporalCovMatern",
    "InvGamma",
    "HalfNormal",
    "Normal",
    "b_fwd_2d",
    "fwd_model_1d",
    "fwd_model_2d",
    "fwd_operator_2d",
]

__version__ = "0.1.0"
