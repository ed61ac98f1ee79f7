"""leapfrogs_per_draw: Leapfrog steps per draw: the change of
``gpcsd_tpu_torch.infer.nuts.evaluations`` over the window, over the window's
draws.
"""

from benchmark.readers import leapfrogs_per_draw as read  # noqa: F401
