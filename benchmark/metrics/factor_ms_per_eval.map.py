"""factor_ms_per_eval.map: Device ms under the program's factorization spans,
``gpcsd.kronlik.comp_eig_d`` and ``gpcsd.kronlik.eigh_backward``, in the
profiled slice, per row evaluation of the slice.
"""

from benchmark.program_readers import factor_ms_per_eval as read  # noqa: F401
