"""The per-layer reader of the program's CUDA-graph counters, shared by the
``graph_replay_share`` files in ``metrics/``.

The program (``gpcsd_tpu_torch.models.pass_graphs``) counts, in its counter
registry, each batched value+grad pass that could replay its CUDA graphs:
``graph.replay`` where it did, ``graph.eager`` where it ran eagerly (a row
count's first sighting, or a capture put off under a profiler).  The reader
returns None for a program without those counters.
"""

from __future__ import annotations

from benchmark.program_readers import _program_counters


def graph_replay_share(ctx):
    """``graph.replay`` over ``graph.replay`` plus ``graph.eager``, for the
    whole run, in %."""
    c = _program_counters()
    if not c:
        return None
    replayed = c.get("graph.replay", 0)
    eligible = replayed + c.get("graph.eager", 0)
    return 100.0 * replayed / eligible if eligible else None
