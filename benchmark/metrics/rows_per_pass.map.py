"""rows_per_pass.map: Rows per batched value+grad pass: the program's
``pass.rows`` over its ``pass.count``, for the whole run.
"""

from benchmark.program_readers import rows_per_pass as read  # noqa: F401
