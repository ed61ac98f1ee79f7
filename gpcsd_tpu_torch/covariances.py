"""Reference import-path alias (``gpcsd.covariances``)."""

from .models.covariances import (  # noqa: F401
    GPCSD1DSpatialCov,
    GPCSD1DSpatialCovSE,
    GPCSD2DSpatialCov,
    GPCSD2DSpatialCovSE,
    GPCSDTemporalCov,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
)
