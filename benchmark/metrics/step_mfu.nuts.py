"""step_mfu.nuts: The whole step's share of the FP64 peak: the benchmark's count
of one row evaluation's operations times the window's row evaluations per
second.
"""

from benchmark.readers import step_mfu as read  # noqa: F401
