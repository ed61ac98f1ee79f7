"""A later change adds a configuration of a new family, whose program is not
a GPCSD model, with a new engine, as files and appended BENCHMARK.json
entries alone: here the family (rows of a seeded convex quadratic, minimized
by the port's batched L-BFGS), its small sizes, the engine's driver with its
own ``plant``, a traffic mix, a limits file and a per-layer reader all come
from a temporary directory.  ``small_bench`` builds every cell of that spec,
the new cell runs untraced and traced on the CPU, its driver's planted fault
reads ``correct`` false, ``faults.planted`` refuses an engine with no
``plant``, and no file of the benchmark changes.  And for today's two
configurations, the small configurations and the traced context's ``shape``
and ``row_eval_flops`` are what they were when the sizes lived in the tests'
code and the context took them from ``benchmark.counts`` alone."""

import hashlib
import json
from types import SimpleNamespace

import pytest

from benchmark import counts, faults
from benchmark import run as harness
from benchmark.tests.helpers import PACKAGE, REPO, small_bench
from benchmark.tests.test_harness_extension import _digest

FAMILY = '''"""Rows of one seeded convex quadratic, 0.5 u'Au - b_r'u, a row per b_r."""

from types import SimpleNamespace

import numpy as np
import torch


def make_data(cfg, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((cfg["dim"], cfg["dim"])))
    A = (q * np.geomspace(1.0, cfg["condition"], cfg["dim"])) @ q.T
    return SimpleNamespace(A=A, b=rng.standard_normal((cfg["rows"], cfg["dim"])))


def build_program(cfg, data, device):
    return SimpleNamespace(A=torch.as_tensor(data.A, device=device),
                           b=torch.as_tensor(data.b, device=device), device=torch.device(device))


def reference_problem(cfg, data, dtype, device):
    return np.linalg.solve(data.A, data.b.T).T


def derive_small(cfg):
    """Nothing of the configuration follows from its sizes."""


def shape(cfg):
    return cfg["rows"], cfg["dim"]


def row_eval_flops(cfg):
    return 4 * cfg["dim"] ** 2
'''

DRIVER = '''"""Solves of every row, back to back, by the port's batched L-BFGS."""

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.trace import Slice


def prepare(cell, data, seed, device):
    return None


def _solve(model, mix):
    from gpcsd_tpu_torch.infer import lbfgs

    def fun(u, b):
        return 0.5 * torch.sum((u @ model.A) * u, dim=-1) - torch.sum(b * u, dim=-1)

    return lbfgs.lbfgs_minimize(fun, torch.zeros_like(model.b), row_data=model.b,
                                max_iter=mix["max_iter"], gtol=1e-10, ftol=0.0)


def run(model, data, cell, seed, seconds, trace, prepared):
    _solve(model, cell.mix)
    t0 = time.perf_counter()
    solves = []
    while not solves or time.perf_counter() - t0 < seconds:
        solves.append(_solve(model, cell.mix))
    t_end = time.perf_counter()
    prof = None
    if trace:
        prof = Slice(model.device)
        prof.start()
        _solve(model, cell.mix)
        prof.stop()
    evals = int(sum(np.sum(r.n_evals) for r in solves))
    return SimpleNamespace(
        t_window_start=t0, e2e={"map_fit_s": (t_end - t0) / len(solves)},
        attempted=len(solves) * model.b.shape[0], failed=0,
        counters={"evals": evals, "solves": len(solves), "window_s": t_end - t0},
        slice=prof, slice_evals=None, check=[r.u.cpu().numpy() for r in solves])


def readings(out, cell, data, seed, device, control=None):
    x = cell.family.reference_problem(cell.config, data, torch.float64, device)
    return {"x_gap": max(float(np.max(np.abs(u - x))) / float(np.max(np.abs(x)))
                         for u in out.check)}


@contextlib.contextmanager
def plant(name):
    from gpcsd_tpu_torch.infer import lbfgs

    if name != "unchanged":
        raise ValueError(f"no fault {name!r} for this engine")
    old = lbfgs.lbfgs_minimize
    lbfgs.lbfgs_minimize = lambda *a, **kw: old(*a, **{**kw, "max_iter": 0})
    try:
        yield
    finally:
        lbfgs.lbfgs_minimize = old
'''

METRIC = '''"""evals_per_row: value-and-gradient evaluations a row per solve."""


def read(ctx):
    c = ctx.counters
    return c["evals"] / c["solves"] / ctx.shape[0] if c.get("solves") else None
'''

FILES = {
    "extra/bowl.json": json.dumps({"name": "bowl", "family": "bowl", "dim": 40, "rows": 16,
                                   "condition": 100.0}),
    "configs/bowl.small.json": json.dumps({"dim": 6, "rows": 3}),
    "configs/bowl.py": FAMILY,
    "drivers/descend.py": DRIVER,
    "traffic/descend-b.json": json.dumps({"engine": "descend", "max_iter": 200}),
    "limits/bowl-descend.json": json.dumps({"x_gap": 1e-6}),
    "metrics/evals_per_row.py": METRIC,
}

#: today's small configurations (sha256 of the file ``small_bench`` writes)
#: and their counts, as the sizes in the tests' code and ``benchmark.counts``
#: gave them
TODAY = {
    "auditory": ("7d3c6b567c549bfc582f6b8a1cf968e15aa2b43a454d9736e5dd9d75e8991ee6",
                 (8, 60, 10), 5260800, (24, 600, 100), 8633352960),
    "neuropixels": ("2cb0c21a4c8ccc80d184d3b54b7e2438417dc2fd27105a77d0aae81052ee9237",
                    (8, 20, 3), 404160, (69, 375, 100), 13157320860),
}


@pytest.fixture
def source(tmp_path):
    """The repository's BENCHMARK.json with the new entries appended, and
    the new files, in a directory of their own."""
    src = tmp_path / "src"
    for rel, text in FILES.items():
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text(text)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        c["file"] = str(REPO / c["file"])
    spec["configs"].append({"name": "bowl", "source": "a test",
                            "file": "extra/bowl.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "bowl-descend", "config": "bowl", "traffic": "descend-b",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "evals_per_row", "unit": "evals", "better": "lower",
                              "source": "program_counter", "layer": "infer.lbfgs",
                              "moves": "map_fit_s", "workloads": ["bowl-descend"]})
    next(m for m in spec["end_to_end"] if m["name"] == "map_fit_s")["workloads"].append(
        "bowl-descend")
    (src / "BENCHMARK.json").write_text(json.dumps(spec))
    return src


def test_new_family_and_engine_from_files_alone(source, tmp_path, monkeypatch):
    # a test process of the suite may have JAX loaded; the run may not
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    before = _digest()
    bench = small_bench(tmp_path / "bench", root=source, dirs=[source])
    cells = {w["name"]: bench.cell(w["name"]) for w in bench.spec["workloads"]}
    cell = cells["bowl-descend"]
    assert cell.config["dim"] == 6 and [m["name"] for m, _ in cell.per_layer] == ["evals_per_row"]

    plain = harness.run_cell(cell, 2**31 + 17, 0.3, False, device="cpu")
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"map_fit_s", "setup_s"}
    traced = harness.run_cell(cell, 2**31 + 18, 0.3, True, device="cpu")
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["evals_per_row"]["value"] >= 1

    with faults.planted("unchanged", cell.mix["engine"], cell.driver):
        broken = harness.run_cell(cell, 2**31 + 19, 0.3, False, device="cpu")
    assert not broken["correct"], broken["checks"]
    assert _digest() == before


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_planted_refuses_an_engine_without_plant(fault):
    with pytest.raises(ValueError, match="defines no plant"):
        with faults.planted(fault, "descend", SimpleNamespace()):
            pass


@pytest.mark.parametrize("name", sorted(TODAY))
def test_todays_configurations_read_as_before(name, tmp_path):
    digest, small_shape, small_flops, full_shape, full_flops = TODAY[name]
    bench = small_bench(tmp_path)
    entry = next(c for c in bench.spec["configs"] if c["name"] == name)
    text = (tmp_path / entry["file"]).read_text()
    assert hashlib.sha256(text.encode()).hexdigest() == digest
    full = json.loads((PACKAGE / "configs" / f"{name}.json").read_text())
    family = harness.load_module(PACKAGE / "configs" / f"{full['family']}.py", f"family_{name}")
    for cfg, shape, flops in ((json.loads(text), small_shape, small_flops),
                              (full, full_shape, full_flops)):
        ctx = harness.Context(config=cfg, family=family)
        assert ctx.shape == counts.shape(cfg) == shape
        assert ctx.row_eval_flops == counts.row_eval_flops(cfg) == flops
