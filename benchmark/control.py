"""Readings that set the limits of ``correct``: the program's, the control's
and a planted fault's, on several seeds in one process.

    python3 -m benchmark.control --workload <name> --seconds <s> --seeds <n> [<n> ...]
        [--fault unchanged|half_batch|altered]

For each seed one run of the cell (untraced); then the numbers compared,
read from the program (``readings``) and from the control (``control``): the
plain reference in float32, TF32 off, put in the program's place at the same
points, one precision below the configurations' float64.  ``correct`` is the
harness's verdict on the control's numbers, which has to come out false.
With ``--fault`` the program runs with that fault planted
(:mod:`benchmark.faults`), the control is not read, and ``correct`` is the
verdict on the faulty program.  One JSON line per seed.
"""

from __future__ import annotations

from benchmark import T_IMPORT  # noqa: F401  isort: skip

import argparse
import contextlib
import json
import sys
from pathlib import Path

from benchmark import faults
from benchmark.run import Bench, _cache_dirs, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=faults.FAULTS)
    args = ap.parse_args(argv)
    _cache_dirs(Path.cwd())
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = Bench(Path.cwd()).cell(args.workload)
    for seed in args.seeds:
        plant = (faults.planted(args.fault, cell.mix["engine"], cell.driver) if args.fault
                 else contextlib.nullcontext())
        with plant:
            r = run_cell(cell, seed, args.seconds, False,
                         control=None if args.fault else torch.float32)
        checked = {k: c["value"] for k, c in r["checks"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "correct": r["correct"], "metrics": r["metrics"],
                          "readings": r.get("program_readings", checked),
                          "control": None if args.fault else checked}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
