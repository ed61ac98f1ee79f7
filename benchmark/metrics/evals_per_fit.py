"""evals_per_fit: Row evaluations per fit: the sum of ``MAPResult.n_evals`` over
a fit's restarts, averaged over the window's whole fits.
"""

from benchmark.readers import evals_per_fit as read  # noqa: F401
