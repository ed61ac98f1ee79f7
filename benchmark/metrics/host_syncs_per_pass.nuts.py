"""host_syncs_per_pass.nuts: Host syncs per batched value+grad pass: the sum of
the program's ``host_sync.*`` counters over its ``pass.count``, for the
whole run.
"""

from benchmark.program_readers import host_syncs_per_pass as read  # noqa: F401
