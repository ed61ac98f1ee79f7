"""The benchmark's counts of operations and bytes against the bounds of the
kernel table in PERF.md (bound ms at (24, 600, 100) and (69, 375, 100))."""

import json

import pytest

from benchmark import counts
from benchmark.tests.helpers import PACKAGE


@pytest.mark.parametrize("shape,bound_ms", [
    ((24, 600, 100), 0.02682268656716418),
    ((69, 375, 100), 0.03429402985074627),
    ((24, 60, 40), 0.00015096597014925374),
])
def test_quadform_bound(shape, bound_ms):
    assert counts.quadform_bound_s(*shape) * 1e3 == pytest.approx(bound_ms, rel=1e-12)


def test_quadform_counts_at_the_paper_shape():
    assert counts.quadform_flops(24, 600, 100) == 1_797_120_000
    assert counts.quadform_bytes(24, 600, 100) == 8 * (1_440_000 + 360_000 + 576 + 14_400 + 1)


@pytest.mark.parametrize("name,gflop", [("auditory", 8.633), ("neuropixels", 13.157)])
def test_row_eval_flops(name, gflop):
    cfg = json.loads((PACKAGE / "configs" / f"{name}.json").read_text())
    assert counts.row_eval_flops(cfg) / 1e9 == pytest.approx(gflop, rel=1e-3)
