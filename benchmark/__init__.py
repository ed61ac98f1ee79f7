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

A configuration of a new family, with a new engine, is added as files and
appended entries alone: its file, its family's code (``make_data``,
``build_program``, ``reference_problem``, and where its readers need them
``shape`` and ``row_eval_flops``), its CPU tests' sizes
``configs/<config>.small.json``, the driver (``prepare``, ``run``,
``readings``, and ``plant`` for its faults, :mod:`benchmark.faults`), the
mix, the limits and the readers; then its entries in ``BENCHMARK.json``
and its cell's name in the ``workloads`` of the end-to-end metric it
reports.
"""

import time

#: The benchmark's clock at import: ``setup_s`` runs from the process's start,
#: which :func:`benchmark.run.process_age_s` adds to this.
T_IMPORT = time.perf_counter()
