"""row_evals_per_s.nuts: Row evaluations of the log-joint's value and gradient
per second of the window (the program's counter, the benchmark's clock; a
traced run leaves its profiled slice out).
"""

from benchmark.readers import row_evals_per_s as read  # noqa: F401
