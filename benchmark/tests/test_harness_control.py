"""The control of the limits fails them: the plain reference in float32
(TF32 off), one precision below the configurations' float64, put in the
program's place at the points a run visited, makes the harness's own
``correct`` come out false in each cell, at a small size on the CPU, on
three seeds, where the program's readings of the same run pass."""

import pytest
import torch

from benchmark import run as harness
from benchmark.tests.helpers import small_bench

MIXES = {"nuts-c4-d3": {"num_warmup": 3},
         "map-r10": {"restarts": 4},
         "map-r20": {"restarts": 4}}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return small_bench(tmp_path_factory.mktemp("bench"), mixes=MIXES)


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**32 + 5])
@pytest.mark.parametrize("workload", ["auditory-nuts", "neuropixels-nuts", "auditory-map",
                                      "neuropixels-map"])
def test_control_fails_a_limit(bench, workload, seed):
    cell = bench.cell(workload)
    result = harness.run_cell(cell, seed, 1.0, False, device="cpu", control=torch.float32)
    program = result["program_readings"]
    assert set(program) == set(cell.limits)
    assert all(program[k] <= lim for k, lim in cell.limits.items()), (program, cell.limits)
    assert result["checks"] and set(result["checks"]) <= set(cell.limits)
    assert not result["correct"], result["checks"]
