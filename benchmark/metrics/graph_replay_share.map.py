"""graph_replay_share.map: Share of the batched value+grad passes that could
replay the program's CUDA graphs and did: its ``graph.replay`` over
``graph.replay`` plus ``graph.eager``, for the whole run, in %.
"""

from benchmark.graph_readers import graph_replay_share as read  # noqa: F401
