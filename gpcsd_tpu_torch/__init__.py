"""gpcsd-tpu-torch: the GPCSD inference engine on PyTorch, for NVIDIA Hopper.

A port of the JAX package ``gpcsd_tpu`` (which stays the reference), module
for module: the quadrature covariances, the factored Kronecker marginal
likelihood with a hand-written CUDA kernel for its quadratic form, the
``GPCSD1D`` and ``GPCSD2D`` models with their MAP fit (L-BFGS batched over
restarts, or scipy), Laplace-whitened dense-metric NUTS posterior with
checkpoint/resume, mean-field ADVI, adaptive tempered SMC, WAIC and
PSIS-LOO, predictions, posterior variance and Matheron posterior samples,
the paper-scale NUTS run (``paper_run``), and the analysis stages behind
the paper's figures: band-pass phases and PLV (``signal``), the torus graph
and its trial bootstrap, per-trial shifts, watershed segmentation, kCSD and
traditional CSD; the text loaders with their native C++ parser
(``io.loaders``, ``native``) and the NWB extraction (``io.nwb``); and twins
of the seven workloads in ``gpcsd_tpu_torch.workloads``, with their
real-data modes.  Float64 on every device, and the card is the default
device.  This package imports neither JAX nor ``gpcsd_tpu``.
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
from .models.trad import predictcsd_trad_1d, predictcsd_trad_2d
from .ops.forward import b_fwd_2d, fwd_model_1d, fwd_model_2d, fwd_operator_2d
from .models.priors import HalfNormal, InvGamma, Normal
from .models.torus_graph import torus_graph_fit, torusGraphs
from .models.shifts import estimate_shifts
from . import signal  # noqa: F401

# Reference-compatible aliases (gpcsd.priors.GPCSD*Prior)
GPCSDInvGammaPrior = InvGamma
GPCSDHalfNormalPrior = HalfNormal

__all__ = [
    "GPCSD1D",
    "GPCSD2D",
    "predictcsd_trad_1d",
    "predictcsd_trad_2d",
    "GPCSD1DSpatialCovSE",
    "GPCSD2DSpatialCovSE",
    "GPCSDTemporalCovSE",
    "GPCSDTemporalCovMatern",
    "InvGamma",
    "HalfNormal",
    "Normal",
    "GPCSDInvGammaPrior",
    "GPCSDHalfNormalPrior",
    "torus_graph_fit",
    "torusGraphs",
    "estimate_shifts",
    "signal",
    "b_fwd_2d",
    "fwd_model_1d",
    "fwd_model_2d",
    "fwd_operator_2d",
]

__version__ = "0.1.0"
