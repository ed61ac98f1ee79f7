"""Reference import-path alias (``gpcsd.priors``)."""

from .models.priors import HalfNormal as GPCSDHalfNormalPrior  # noqa: F401
from .models.priors import InvGamma as GPCSDInvGammaPrior  # noqa: F401
from .models.priors import Prior as GPCSDPrior  # noqa: F401
