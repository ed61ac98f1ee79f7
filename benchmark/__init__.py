"""The benchmark of ``gpcsd_tpu_torch`` on one NVIDIA H100.

One command runs one cell of ``BENCHMARK.json``::

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the configuration's file
``configs/<config>.json`` (and its family's code ``configs/<family>.py``),
the traffic mix ``traffic/<mix>.json`` (whose ``engine`` names the driver
``drivers/<engine>.py``), the correctness limits ``limits/<workload>.json``
and one reader ``metrics/<metric>.py`` per per-layer metric.  The plain
reference that decides ``correct`` is ``reference/``; it imports nothing of
the program.
"""

import time

#: The benchmark's clock at import: ``setup_s`` runs from the process's start,
#: which :func:`benchmark.run.process_age_s` adds to this.
T_IMPORT = time.perf_counter()
