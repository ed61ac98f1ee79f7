"""Reference import-path alias (``gpcsd.gpcsd2d``)."""

from .models.gpcsd2d import GPCSD2D, JITTER  # noqa: F401
