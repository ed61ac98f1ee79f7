"""The per-layer readers of the program's own spans and counters, shared by
the files in ``metrics/``.

The program (``gpcsd_tpu_torch.utils.profiling``) names its layers' ranges
in the profiler's record (``gpcsd.kronlik.comp_eig_d``, ...), so the device
time under each comes out of the profiled slice (``op_device_s``, by name),
and it keeps a registry of event counters (``pass.count``, ``pass.rows``,
``host_sync.<site>``) over the whole run.  Each reader takes the run's
context as :mod:`benchmark.readers` describes it and returns a number, or
None where the run gives it nothing to read: no device time under the span
(on the CPU), or a program without the span or the registry.  A share of a
roofline is never made 0 or clipped.
"""

from __future__ import annotations

from benchmark import counts

#: the program's spans over the factorization: the forward (the ``eigh``s
#: and ``D``) and the backward of the ``eigh``s, on autograd's thread
FACTOR_SPANS = ("gpcsd.kronlik.comp_eig_d", "gpcsd.kronlik.eigh_backward")
#: the program's span over the quadratic term: the reciprocal of ``D`` and
#: the kernel launches
QUAD_TERM_SPAN = "gpcsd.kronlik.quad_term"


def _span_device_s(ctx, names):
    """Device seconds under the spans ``names`` in the profiled slice, or
    None where there are none."""
    s = ctx.slice
    if not s:
        return None
    total = sum(s["op_device_s"].get(name, 0.0) for name in names)
    return total if total > 0 else None


def _program_counters():
    """The program's counter registry, or None for a program without one."""
    try:
        from gpcsd_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return read() if callable(read) else None


def factor_ms_per_eval(ctx):
    """Device ms under the factorization's spans, per row evaluation of the slice."""
    seconds = _span_device_s(ctx, FACTOR_SPANS)
    if seconds is None or not ctx.slice_evals:
        return None
    return 1e3 * seconds / ctx.slice_evals


def quad_term_roofline(ctx):
    """The quadratic term's bound at the cell's shape times the slice's row
    evaluations, over the device time under its span in the slice, in %."""
    seconds = _span_device_s(ctx, (QUAD_TERM_SPAN,))
    if seconds is None or not ctx.slice_evals:
        return None
    return 100.0 * counts.quadform_bound_s(*ctx.shape) * ctx.slice_evals / seconds


def host_syncs_per_pass(ctx):
    """Host syncs the program counted (every ``host_sync.*``) per batched
    value+grad pass, over the whole run."""
    c = _program_counters()
    if not c or not c.get("pass.count"):
        return None
    return sum(v for k, v in c.items() if k.startswith("host_sync.")) / c["pass.count"]


def rows_per_pass(ctx):
    """Rows evaluated per batched value+grad pass, over the whole run."""
    c = _program_counters()
    if not c or not c.get("pass.count"):
        return None
    return c["pass.rows"] / c["pass.count"]
