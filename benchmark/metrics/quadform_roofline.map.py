"""quadform_roofline.map: The quadratic term's roofline share: the benchmark's
bound at the cell's ``(nx, nt, ntrials)`` over the device time of
``gpcsd_tpu_torch.ops.kronlik.quad_term`` there (CUDA events over 50 calls
after the window, on the factors of the model's current point).
"""

from benchmark.readers import quadform_roofline as read  # noqa: F401
