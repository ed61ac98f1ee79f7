"""Command line of the PyTorch port's likelihood noise probe
(:mod:`gpcsd_tpu_torch.noise_probe`), from the repository root:

    python3 scripts/torch_noise_probe.py --het-exact
    python3 scripts/torch_noise_probe.py --device cpu
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpcsd_tpu_torch.noise_probe import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
