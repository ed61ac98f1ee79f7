"""jacobi_sweeps_per_solve.map: Sweeps of the program's block-Jacobi
eigensolver per temporal factor it solved: its ``kronlik.jacobi.sweeps``
over ``kronlik.jacobi.rows``, for the whole run.
"""

from benchmark.jacobi_readers import jacobi_sweeps_per_solve as read  # noqa: F401
