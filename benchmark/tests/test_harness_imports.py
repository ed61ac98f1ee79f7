"""What a run loads: no module of JAX or of the JAX package (top-level names
compared whole, since ``gpcsd_tpu_torch`` starts with ``gpcsd_tpu``); the
reference and the data path nothing of the program; and the command's exits
without a card and without the program."""

import ast
import json
import shutil
import subprocess
import sys

from benchmark.run import FORBIDDEN_MODULES
from benchmark.tests.helpers import PACKAGE, REPO

RUN_ALL = """
import json, sys, tempfile
from benchmark.tests.helpers import small_bench
from benchmark import run as harness
bench = small_bench(tempfile.mkdtemp(), mixes={
    "nuts-c4-d3": {"num_warmup": 2, "trace_transitions": 2, "check_draws": 3},
    "map-r10": {"restarts": 2, "trace_iters": 2}})
for w in ("auditory-nuts", "neuropixels-nuts", "auditory-map"):
    for trace in (False, True):
        harness.run_cell(bench.cell(w), 11, 0.5, trace, device="cpu")
print(json.dumps({"forbidden": harness.forbidden_modules(),
                  "program": "gpcsd_tpu_torch" in sys.modules}))
"""

DATA_ONLY = """
import json, sys
from benchmark import run as harness
from benchmark.tests.helpers import PACKAGE
for name, family, small in (("auditory", "gpcsd1d", {"surrogate_samples": 40, "nt": 20, "ntrials": 3}),
                            ("neuropixels", "gpcsd2d", {"nt": 20, "ntrials": 3, "ngl": [6, 10]})):
    cfg = json.loads((PACKAGE / "configs" / f"{name}.json").read_text())
    cfg.update(small)
    fam = harness.load_module(PACKAGE / "configs" / f"{family}.py", family)
    import torch
    data = fam.make_data(cfg, 3)
    fam.reference_problem(cfg, data, torch.float64, "cpu").log_prob(
        fam.reference_problem(cfg, data, torch.float64, "cpu").pack(data.truth))
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in ("gpcsd_tpu_torch",) + %r)))
""" % (FORBIDDEN_MODULES,)


def _python(code, cwd=REPO, timeout=600):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in PACKAGE.rglob("*.py"):
        assert not _imports(path) & set(FORBIDDEN_MODULES), path


def test_reference_imports_nothing_of_the_program():
    for path in (PACKAGE / "reference").glob("*.py"):
        assert "gpcsd_tpu_torch" not in _imports(path), path


def test_data_and_reference_load_nothing_of_the_program():
    proc = _python(DATA_ONLY)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.splitlines()[-1]) == []


def test_a_run_of_each_mix_loads_no_jax():
    proc = _python(RUN_ALL)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == {"forbidden": [], "program": True}


def test_command_without_a_card_exits_without_a_result():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "auditory-nuts",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PACKAGE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _python("import sys; from benchmark import run as h; "
                   "sys.exit(h.run_cell(h.Bench('.').cell('auditory-map'), 1, 1, False, device='cpu') is None)",
                   cwd=tmp_path)
    assert proc.returncode != 0 and "gpcsd_tpu_torch" in proc.stderr and proc.stdout == ""
