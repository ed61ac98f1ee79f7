"""Small configurations of the benchmark's cells for CPU tests, and a
``Bench`` over a temporary root that holds them.

A configuration's small sizes are the file ``configs/<name>.small.json``
beside the harness's files (found as :class:`benchmark.run.Bench` finds
them): the keys it changes in the configuration.  Its family may define
``derive_small(cfg)``, which brings what the configuration derives from its
sizes in line with them; a family without one gets
:func:`params_from_program`, which needs a program with ``_fns`` and leaves
the configuration as it is otherwise.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from benchmark import run as harness

REPO = Path(__file__).resolve().parents[2]
PACKAGE = REPO / "benchmark"


def params_from_program(cfg, family):
    """Set the sizes and bounds of ``cfg['params']`` as the family's program
    derives them at the configuration's sizes (its ``_fns().param_set``)."""
    model = family.build_program(cfg, family.make_data(cfg, 0), "cpu")
    if not hasattr(model, "_fns"):
        return
    ps = model._fns().param_set
    for p in cfg["params"]:
        s = ps.specs[p["name"]]
        p["size"] = s.size
        p["lo"] = float(np.asarray(s.lo).reshape(-1)[0])
        hi = float(np.asarray(s.hi).reshape(-1)[0])
        p["hi"] = None if hi == float("inf") else hi


def small_config(name, root=REPO, dirs=(), **extra):
    """The configuration ``name`` of ``root``'s BENCHMARK.json at its small
    sizes (``configs/<name>.small.json`` in ``dirs`` or the package), with
    ``extra`` keys changed and its family's ``derive_small`` applied."""
    src = harness.Bench(root, dirs=[*dirs, PACKAGE])
    entry = next(c for c in src.spec["configs"] if c["name"] == name)
    cfg = json.loads((Path(root) / entry["file"]).read_text())
    cfg.update(json.loads(src.find("configs", name, ".small.json").read_text()), **extra)
    family = harness.load_module(src.find("configs", cfg["family"], ".py"), "family")
    derive = getattr(family, "derive_small", None)
    if derive is not None:
        derive(cfg)
    else:
        params_from_program(cfg, family)
    return cfg


def small_bench(tmp_path, mixes=None, limits=None, root=REPO, dirs=()):
    """A ``Bench`` at ``tmp_path`` whose BENCHMARK.json is ``root``'s with
    every configuration at its small sizes, over the harness's files in
    ``dirs`` and the package; traffic mixes can be overridden per name
    (``mixes``: name -> dict of keys to change), and limits per workload."""
    tmp_path = Path(tmp_path)
    src = harness.Bench(root, dirs=[*dirs, PACKAGE])
    spec = json.loads((Path(root) / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = tmp_path / "configs" / f"{c['name']}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(small_config(c["name"], root=root, dirs=dirs)))
        c["file"] = str(path.relative_to(tmp_path))
    for name, changes in (mixes or {}).items():
        mix = json.loads(src.find("traffic", name, ".json").read_text())
        mix.update(changes)
        (tmp_path / "traffic").mkdir(exist_ok=True)
        (tmp_path / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, lim in (limits or {}).items():
        (tmp_path / "limits").mkdir(exist_ok=True)
        (tmp_path / "limits" / f"{name}.json").write_text(json.dumps(lim))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(tmp_path, dirs=[tmp_path, *dirs, PACKAGE])
