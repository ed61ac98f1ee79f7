"""eigh_ms_per_eval.nuts: Device ms under ``aten::linalg_eigh``
(``torch.profiler``'s ``key_averages``) in the profiled slice, per row
evaluation of the slice.
"""

from benchmark.readers import eigh_ms_per_eval as read  # noqa: F401
