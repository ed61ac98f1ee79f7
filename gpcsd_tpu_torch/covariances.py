"""Reference import-path alias (``gpcsd.covariances``).  The port's 1D
spatial covariance has no separate base class: ``GPCSD1DSpatialCovSE`` is
the whole of it."""

from .models.covariances import (  # noqa: F401
    GPCSD1DSpatialCovSE,
    GPCSD2DSpatialCov,
    GPCSD2DSpatialCovSE,
    GPCSDTemporalCov,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
)
