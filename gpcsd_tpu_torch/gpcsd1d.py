"""Reference import-path alias: ``from gpcsd_tpu_torch.gpcsd1d import GPCSD1D``
mirrors ``from gpcsd.gpcsd1d import GPCSD1D`` (reference layout)."""

from .models.gpcsd1d import GPCSD1D, JITTER  # noqa: F401
