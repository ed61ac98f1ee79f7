"""What a run reports: ``setup_s`` leaves out the reference's own work at
set-up, and no result is printed when a module of JAX or of the JAX package
is loaded by the time it would be."""

import json
import sys
import time
import types
from types import SimpleNamespace

from benchmark import run as harness
from benchmark.tests.helpers import small_bench

REFERENCE_S = 2.0


def test_setup_leaves_out_the_reference(tmp_path, monkeypatch):
    cell = small_bench(tmp_path, mixes={"nuts-c4-d3": {"num_warmup": 2, "check_draws": 3}}).cell(
        "auditory-nuts")
    driver, seen = cell.driver, {}

    def prepare(*args):
        out = driver.prepare(*args)
        time.sleep(REFERENCE_S)
        return out

    def run(*args):
        seen["out"] = driver.run(*args)
        return seen["out"]

    cell.driver = SimpleNamespace(prepare=prepare, run=run, readings=driver.readings)
    monkeypatch.setattr(harness, "process_age_s", lambda: 0.0)
    monkeypatch.setattr(harness, "T_IMPORT", time.perf_counter())
    result = harness.run_cell(cell, 2**31 + 21, 0.5, False, device="cpu")
    assert result["correct"], result["checks"]
    to_window = seen["out"].t_window_start - harness.T_IMPORT
    assert 0 < result["metrics"]["setup_s"]["value"] <= to_window - REFERENCE_S


def test_no_result_once_a_forbidden_module_is_loaded(monkeypatch, capsys):
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
              "checks": {"logp_gap": {"value": 0.0, "limit": 1e-9}}}
    assert harness.report(result) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == result
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.report(result) == 3
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "gpcsd_tpu_torch_like", types.ModuleType("gpcsd_tpu_torch_like"))
    assert harness.report(result) == 0
