"""Twins of the JAX package's workload pipelines (``workloads/``) on the
PyTorch port: the same stages, defaults, flags and metric names, with the
tensors on the device from the fit to the last stage, and no figures."""
