"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's cards.  The cell's
configuration, traffic mix, driver, limits and per-layer readers are found
by name (see :class:`Bench`).  The run makes its data from the seed, builds
the program's model, lets the mix's driver run set-up and the window, reads
the end-to-end metrics (``--trace 0``) or the per-layer metrics
(``--trace 1``: a profiled slice, read by each metric's reader), frees the
program and checks what the window produced against the plain reference.
Standard error ends with each compared number beside its limit; the last line
of standard output is the result, a JSON object.

Exits 2 without a result when CUDA or the cell's cards are missing, and 3
when a module of JAX or of the JAX package is loaded once the window has
closed or when the result is about to be printed.
"""

from __future__ import annotations

from benchmark import T_IMPORT  # isort: skip  (the set-up clock starts here)

import argparse
import functools
import gc
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from benchmark import counts

#: top-level module names no run may load (compared whole: the port's name
#: starts with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gpcsd_tpu")

PACKAGE_DIR = Path(__file__).resolve().parent


def process_age_s() -> float:
    """Seconds the process had run when :mod:`benchmark` was imported
    (Linux ``/proc``; 0 where it cannot be read)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    age_now = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return max(age_now - (time.perf_counter() - T_IMPORT), 0.0)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def _forbidden_loaded(when) -> bool:
    """Whether a forbidden module is loaded; names it on standard error if so."""
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package are loaded {when}: {bad}", file=sys.stderr)
    return bool(bad)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(re.sub(r"[^A-Za-z0-9_]", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names.

    Names are found as ``configs/<family>.py``, ``traffic/<mix>.json``,
    ``drivers/<engine>.py``, ``limits/<workload>.json`` and
    ``metrics/<metric>.py`` in the first of ``dirs`` that holds them
    (default: this package's directory); a configuration's file is the
    ``file`` its entry names, relative to ``root``.
    """

    def __init__(self, root, dirs=None):
        self.root = Path(root)
        self.dirs = [Path(d) for d in (dirs or [PACKAGE_DIR])]
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def find(self, kind, name, suffix):
        for d in self.dirs:
            path = d / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind}/{name}{suffix} in {[str(d) for d in self.dirs]}")

    def cell(self, workload):
        by_name = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        w = by_name[workload]
        centry = next(c for c in self.spec["configs"] if c["name"] == w["config"])
        config = json.loads((self.root / centry["file"]).read_text())
        mix = json.loads(self.find("traffic", w["traffic"], ".json").read_text())
        end_to_end = [m for m in self.spec["end_to_end"]
                      if "workloads" not in m or workload in m["workloads"]]
        reported = {m["name"] for m in end_to_end}
        per_layer = [m for m in self.spec["per_layer"]
                     if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        return SimpleNamespace(
            name=workload, chips=w["chips"], config=config, mix=mix,
            family=load_module(self.find("configs", config["family"], ".py"),
                               f"benchmark_family_{config['family']}"),
            driver=load_module(self.find("drivers", mix["engine"], ".py"),
                               f"benchmark_driver_{mix['engine']}"),
            limits=json.loads(self.find("limits", workload, ".json").read_text()),
            end_to_end=end_to_end,
            per_layer=[(m, load_module(self.find("metrics", m["name"], ".py"),
                                       f"benchmark_metric_{m['name']}")) for m in per_layer],
        )


class Context(SimpleNamespace):
    """What a per-layer reader reads (see :mod:`benchmark.readers`).

    ``shape`` and ``row_eval_flops`` are the family's ``shape(cfg)`` and
    ``row_eval_flops(cfg)`` where it defines them, else
    :mod:`benchmark.counts`'s, worked out when a reader first reads them: a
    family whose configuration has no GP sizes needs neither.
    """

    def _count(self, name):
        return getattr(self.family, name, getattr(counts, name))(self.config)

    @functools.cached_property
    def shape(self):
        return self._count("shape")

    @functools.cached_property
    def row_eval_flops(self):
        return self._count("row_eval_flops")


def _device_info(device):
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(cell, seed, seconds, trace, device="cuda", control=None):
    """Run ``cell`` and return its result (a dict), or None when a forbidden
    module was loaded (named on standard error).

    :param control: ``None``, or a dtype: the plain reference in that dtype
        stands in for the program in the comparison (the control of the
        limits).  ``checks`` and ``correct`` are then the control's, on the
        numbers it reads, and the program's own readings are kept under
        ``program_readings``.
    """
    import torch

    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = cell.family.make_data(cell.config, seed)
    t_prepare = time.perf_counter()
    prepared = cell.driver.prepare(cell, data, seed, device)
    # the reference's own work for the run: not the program's set-up
    reference_s = time.perf_counter() - t_prepare
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model = cell.family.build_program(cell.config, data, device)
    out = cell.driver.run(model, data, cell, seed, seconds, trace, prepared)
    t_closed = time.perf_counter()
    device_info = _device_info(device)
    if _forbidden_loaded("once the window has closed"):
        return None
    setup_s = out.t_window_start - T_IMPORT + process_age_s() - reference_s
    result = {"correct": False, "attempted": out.attempted, "failed": out.failed}
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else out.e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        summary = out.slice.summary() if out.slice is not None else None
        t_summary = time.perf_counter()
        ctx = Context(
            counters=out.counters, slice=summary, slice_evals=out.slice_evals,
            config=cell.config, family=cell.family, model=model, data=data, device=device,
        )
        for m, reader in cell.per_layer:
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        print(f"trace: slice summary {t_summary - t_closed:.3f} s, readers "
              f"{time.perf_counter() - t_summary:.3f} s", file=sys.stderr)
        if summary is not None:
            device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = cell.driver.readings(out, cell, data, seed, device)
    limits = cell.limits
    if control is not None:
        result["program_readings"] = readings
        problem = cell.family.reference_problem(cell.config, data, control, device)
        readings = cell.driver.readings(out, cell, data, seed, device, control=problem)
        limits = {name: lim for name, lim in limits.items() if name in readings}
    print(f"phases: set-up {setup_s:.3f} s (the reference's {reference_s:.3f} s left out), "
          f"window {out.counters['window_s']:.3f} s, after the window {t_check - t_closed:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = {name: {"value": readings[name], "limit": limit} for name, limit in limits.items()}
    result["correct"] = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                            for c in checks.values())
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = checks
    return result


def _cache_dirs(root: Path):
    """Build and kernel caches inside the checkout, at fixed paths."""
    base = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def report(result) -> int:
    """Print ``result`` (None: a forbidden module was loaded) as the run's
    last lines, each compared number beside its limit on standard error and
    the result on standard output, and return the exit code: 3 and no
    result when a forbidden module is loaded by now."""
    if result is None or _forbidden_loaded("before the result is printed"):
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {float(c['value'])!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    _cache_dirs(root)
    import torch

    cell = Bench(root).cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return report(run_cell(cell, args.seed, args.seconds, bool(args.trace)))


if __name__ == "__main__":
    sys.exit(main())
