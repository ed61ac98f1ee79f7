"""The per-layer reader of the program's eigensolver counters, shared by the
``jacobi_sweeps_per_solve`` files in ``metrics/``.

The program (``gpcsd_tpu_torch.ops.cuda.eigh``) counts, in its counter
registry, the temporal factors its block-Jacobi kernel solves on the card
(``kronlik.jacobi.rows``) and the sweeps they took
(``kronlik.jacobi.sweeps``, summed on the device and read when the registry
is read).  The reader returns None for a program without those counters.
"""

from __future__ import annotations

from benchmark.program_readers import _program_counters


def jacobi_sweeps_per_solve(ctx):
    """``kronlik.jacobi.sweeps`` over ``kronlik.jacobi.rows``, for the whole
    run."""
    c = _program_counters()
    if not c or not c.get("kronlik.jacobi.rows") or "kronlik.jacobi.sweeps" not in c:
        return None
    return c["kronlik.jacobi.sweeps"] / c["kronlik.jacobi.rows"]
