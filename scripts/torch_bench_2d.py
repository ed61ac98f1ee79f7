"""Command line of the PyTorch port's 2D bench (:func:`gpcsd_tpu_torch.bench.main_2d`),
the twin of ``scripts/bench_2d.py``, from the repository root on a machine with a
card:

    python3 scripts/torch_bench_2d.py

Prints the card, the torch version and every timed repeat, then ``bench_2d.py``'s
JSON line at the Neuropixels point.  Without a card it exits 2.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpcsd_tpu_torch.bench import main_2d  # noqa: E402

if __name__ == "__main__":
    sys.exit(main_2d())
