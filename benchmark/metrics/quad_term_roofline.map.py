"""quad_term_roofline.map: The quadratic term's roofline share in the window's
own calls: the benchmark's bound at the cell's ``(nx, nt, ntrials)`` times the
slice's row evaluations, over the device time under the program's span
``gpcsd.kronlik.quad_term`` in the profiled slice.
"""

from benchmark.program_readers import quad_term_roofline as read  # noqa: F401
