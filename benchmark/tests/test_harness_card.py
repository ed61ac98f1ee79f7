"""On the card: the command runs each cell briefly, untraced and traced, and
prints a result line that meets the contract (keys, device, metrics named in
BENCHMARK.json, ``checks`` last, ``correct``).  Skips without a card.

    python -m pytest benchmark/tests/test_harness_card.py -m cuda -q
"""

import json
import subprocess
import sys

import pytest

from benchmark.tests.helpers import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_on_the_card(workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                           "--seed", str(2**31 + 77 + trace), "--seconds", "5", "--trace", str(trace)],
                          cwd=REPO, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert list(result)[-1] == "checks" and result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in SPEC[kind] if workload in m.get("workloads", [workload])}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names
    else:
        assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
