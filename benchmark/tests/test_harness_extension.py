"""A later change adds a configuration, a traffic mix, a cell and a per-layer
metric as files and BENCHMARK.json entries alone: here all four come from a
temporary directory, the harness runs the new cell on the CPU at a small
size, and no file of the benchmark changes."""

import hashlib
import json

from benchmark import run as harness
from benchmark.tests.helpers import PACKAGE, REPO, small_config

METRIC = '''"""transitions_per_s: sampling transitions a second (a throwaway reader)."""


def read(ctx):
    c = ctx.counters
    return c["draws"] / 2 / c["window_s"] if c.get("draws") else None
'''


def _digest():
    h = hashlib.sha256()
    for p in sorted(PACKAGE.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(PACKAGE)).encode() + p.read_bytes())
    return h.hexdigest()


def test_cell_added_from_data_and_a_reader(tmp_path):
    before = _digest()
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = dict(small_config("auditory"), name="throwaway")
    (tmp_path / "extra").mkdir()
    (tmp_path / "extra" / "throwaway.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "throwaway", "source": "https://arxiv.org/abs/2104.10070",
                            "file": "extra/throwaway.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "throwaway-nuts", "config": "throwaway",
                              "traffic": "nuts-throwaway", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "transitions_per_s", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "infer.nuts (sampler)",
                              "moves": "draws_per_s", "workloads": ["throwaway-nuts"]})
    for m in spec["end_to_end"]:
        if m["name"] == "draws_per_s":
            m["workloads"].append("throwaway-nuts")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for kind, name, text in (
            ("traffic", "nuts-throwaway.json", json.dumps({
                "engine": "nuts", "chains": 2, "max_depth": 4, "num_warmup": 2,
                "trace_transitions": 2, "check_draws": 3})),
            ("limits", "throwaway-nuts.json", json.dumps({"logp_gap": 1.0, "grad_gap": 1.0})),
            ("metrics", "transitions_per_s.py", METRIC)):
        (tmp_path / kind).mkdir(exist_ok=True)
        (tmp_path / kind / name).write_text(text)

    bench = harness.Bench(tmp_path, dirs=[tmp_path, PACKAGE])
    cell = bench.cell("throwaway-nuts")
    assert [m["name"] for m, _ in cell.per_layer] == ["transitions_per_s"]
    plain = harness.run_cell(cell, 2**31 + 7, 1.0, False, device="cpu")
    assert set(plain["metrics"]) == {"draws_per_s", "setup_s"}
    traced = harness.run_cell(cell, 2**31 + 8, 1.0, True, device="cpu")
    assert traced["metrics"]["transitions_per_s"]["value"] > 0
    assert plain["correct"] and traced["correct"]
    assert list(plain)[-1] == "checks" and set(plain["checks"]) == {"logp_gap", "grad_gap"}
    assert _digest() == before
