"""Command line of the PyTorch port's paper-scale NUTS run
(:mod:`gpcsd_tpu_torch.paper_run`), from the repository root:

    python3 scripts/torch_paper_nuts_run.py --out-dir results/torch_paper_nuts_hetx
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpcsd_tpu_torch.paper_run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
