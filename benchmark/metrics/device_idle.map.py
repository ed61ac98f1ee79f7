"""device_idle.map: Share of the profiled slice's wall time in which no kernel or
copy ran on the card (1 - union of device intervals / wall time).
"""

from benchmark.readers import device_idle as read  # noqa: F401
