"""``correct`` comes out false when the timed path is broken underneath: for
each cell and each fault it can have (a step that returns its state
unchanged; half of the trials left out, the mean taken over the rest; the
quadratic term altered where it is produced), a run at a small size on the
CPU, the harness's look for a card skipped.  A sound run passes the same
limits.  The cells run on one card, so there is no exchange between cards to
leave out."""

import pytest

from benchmark import faults
from benchmark import run as harness
from benchmark.tests.helpers import small_bench

MIXES = {"nuts-c4-d3": {"num_warmup": 3},
         "map-r10": {"restarts": 4},
         "map-r20": {"restarts": 4}}
CELLS = ("auditory-nuts", "neuropixels-nuts", "auditory-map", "neuropixels-map")
SEED = 2**31 + 99


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return small_bench(tmp_path_factory.mktemp("bench"), mixes=MIXES)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(bench, workload):
    result = harness.run_cell(bench.cell(workload), SEED, 1.5, False, device="cpu")
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_makes_the_run_incorrect(bench, workload, fault):
    cell = bench.cell(workload)
    with faults.planted(fault, cell.mix["engine"]):
        result = harness.run_cell(cell, SEED, 1.5, False, device="cpu")
    assert not result["correct"], result["checks"]
