"""The per-layer readers' arithmetic, shared by the files in ``metrics/``.

Each reader takes the run's context (:class:`benchmark.run.Context`:
``counters`` of the window, the profiled ``slice`` summary and its row
evaluations ``slice_evals``, the cell's ``config``, ``shape`` and
``row_eval_flops``, and the program under test: its ``model`` after the
window, the run's ``data``, the configuration's ``family`` module and the
``device``) and returns a number, or None where the run gives it nothing to
read.  A share of a roofline or of a peak is never made 0 or clipped: a
missing reading is None.
"""

from __future__ import annotations

from benchmark import counts


def leapfrogs_per_draw(ctx):
    """Row evaluations of the sampler in the window per draw: leapfrog steps a draw."""
    c = ctx.counters
    return c["evals"] / c["draws"] if c.get("draws") else None


def evals_per_fit(ctx):
    """Value-and-gradient row evaluations summed over a fit's restarts, per whole fit."""
    c = ctx.counters
    return c["evals"] / c["fits"] if c.get("fits") else None


def row_evals_per_s(ctx):
    """Row evaluations per second of the window (its unprofiled part)."""
    c = ctx.counters
    return c["rate_evals"] / c["rate_s"] if c.get("rate_s", 0) > 0 and c["rate_evals"] > 0 else None


def step_mfu(ctx):
    """Counted operations of the window's row evaluations per second, in % of the FP64 peak."""
    rate = row_evals_per_s(ctx)
    return None if rate is None else 100.0 * rate * ctx.row_eval_flops / counts.PEAK_FP64_FLOPS


def device_idle(ctx):
    """Share of the profiled slice's wall time in which no kernel or copy ran, in %."""
    s = ctx.slice
    if not s or not s["window_s"] > 0 or not s["busy_s"] > 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
