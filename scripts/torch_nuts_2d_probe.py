"""Command line of the PyTorch port's 2D NUTS probe
(:mod:`gpcsd_tpu_torch.nuts_2d_probe`), the twin of ``scripts/nuts_2d_probe.py``,
from the repository root:

    python3 scripts/torch_nuts_2d_probe.py --dense-mass --warmup 100 --samples 100 --max-depth 6
    python3 scripts/torch_nuts_2d_probe.py --device cpu --nt 20 --ntrials 3 --ngl1 8 --ngl2 12 \\
        --chains 2 --warmup 4 --samples 4 --max-depth 3 --out-dir chiprun_out/probe_cpu

Exit code 3 after ``--max-seconds`` at a saved transition: rerun to continue.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpcsd_tpu_torch.nuts_2d_probe import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
