"""Reference import-path alias (``gpcsd.forward_models``)."""

from .ops.forward import b_fwd_1d, b_fwd_2d, fwd_model_1d, fwd_model_2d  # noqa: F401
