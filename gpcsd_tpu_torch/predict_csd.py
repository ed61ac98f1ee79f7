"""Reference import-path alias (``gpcsd.predict_csd``)."""

from .models.trad import predictcsd_trad_1d, predictcsd_trad_2d  # noqa: F401
