"""Command line of the PyTorch port's bench (:func:`gpcsd_tpu_torch.bench.main`),
the twin of ``bench.py``, from the repository root on a machine with a card:

    python3 scripts/torch_bench.py

Prints the card, the torch version and every timed repeat, then ``bench.py``'s
two JSON lines (log-joint value+grad evals/s, health-gated NUTS samples/s).
Without a card it exits 2.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpcsd_tpu_torch.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
