"""Persistence: reference-compatible parameter pickles and sampler state."""
