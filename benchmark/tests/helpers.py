"""Small configurations of the benchmark's cells for CPU tests, and a
``Bench`` over a temporary root that holds them."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from benchmark import run as harness

REPO = Path(__file__).resolve().parents[2]
PACKAGE = REPO / "benchmark"

#: per configuration: sizes small enough for a CPU run of a few seconds
SMALL = {
    "auditory": {"nx": 8, "electrodes_um": [0.0, 700.0], "quadrature_um": [-200.0, 900.0],
                 "ngl": 30, "surrogate_samples": 120, "nt": 60, "ntrials": 10},
    "neuropixels": {"nx": 8, "ngl": [6, 10], "nt": 20, "ntrials": 3},
}


def small_config(name, **extra):
    """The configuration ``name`` at its small sizes, with the bounds and
    sizes of its ``params`` as the program's model derives them there."""
    cfg = json.loads((PACKAGE / "configs" / f"{name}.json").read_text())
    cfg.update(SMALL[name], **extra)
    family = harness.load_module(PACKAGE / "configs" / f"{cfg['family']}.py", "family")
    data = family.make_data(cfg, 0)
    model = family.build_program(cfg, data, "cpu")
    ps = model._fns().param_set
    for p in cfg["params"]:
        s = ps.specs[p["name"]]
        p["size"] = s.size
        p["lo"] = float(np.asarray(s.lo).reshape(-1)[0])
        hi = float(np.asarray(s.hi).reshape(-1)[0])
        p["hi"] = None if hi == float("inf") else hi
    return cfg


def small_bench(tmp_path, mixes=None, limits=None):
    """A ``Bench`` at ``tmp_path`` whose BENCHMARK.json is the repository's
    with every configuration at its small sizes; traffic mixes can be
    overridden per name (``mixes``: name -> dict of keys to change), and
    limits per workload."""
    tmp_path = Path(tmp_path)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = tmp_path / "configs" / f"{c['name']}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(small_config(c["name"])))
        c["file"] = str(path.relative_to(tmp_path))
    for name, changes in (mixes or {}).items():
        mix = json.loads((PACKAGE / "traffic" / f"{name}.json").read_text())
        mix.update(changes)
        (tmp_path / "traffic").mkdir(exist_ok=True)
        (tmp_path / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, lim in (limits or {}).items():
        (tmp_path / "limits").mkdir(exist_ok=True)
        (tmp_path / "limits" / f"{name}.json").write_text(json.dumps(lim))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(tmp_path, dirs=[tmp_path, PACKAGE])

