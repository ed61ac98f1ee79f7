#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gpcsd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (covariances -> two float64 eighs -> Kronecker
log-joint value and gradient through the hand-written quadform kernel ->
scipy L-BFGS-B MAP steps) at the auditory paper configuration: GPCSD1D,
nx=24, nt=600, 100 trials, ngl=100, SE + Matern-1/2, 24 per-channel noise
variances, het_noise="exact".  Phases, one JSON line each:

1. device: torch/CUDA versions and the card's name and power limit;
2. build: compile ``gpcsd_tpu_torch/csrc/quadform.cu`` for sm_90a; print
   ptxas's registers and spills and ``cuobjdump -sass`` counts of the FP64
   tensor-core (``DMMA``) and async-copy (``LDGSTS``, ``UTMALDG``)
   instructions;
3. kernel: quadform kernel vs its plain PyTorch version, value and
   gradients, at ``KERNEL_SHAPES``: the main path's (24, 600, 100), the
   paper's other shapes, and edges of the kernel's tiling (one trial, odd
   nt, a trial over several row tiles, nx = 811 and 1000, a 1 x 8 trial);
   two calls must give the same bits;
4. log_prob: value and gradient at the first 8 draws of the banked paper
   posterior, against the banked CPU-f64 values and the port on the CPU;
5. the quadform launch count of phase 4 is non-zero;
6. fit: 2 restarts x 10 L-BFGS-B iterations on the card;
7. timing: log-joint value+grad evals/s at the JAX bench point, and the
   kernel vs its plain version at the main-path shape, both as device time
   (50 calls captured in one CUDA graph, replays timed with events: no
   host launch cost) and as eager calls timed with events.

Any failure raises and the script exits non-zero.  Without CUDA, or run
outside a checkout of the repository, it fails before printing a result.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HETX = os.path.join(ROOT, "results", "paper_nuts_hetx")
KERNEL_SHAPES = [
    (24, 600, 100), (7, 129, 3), (69, 375, 5),
    (24, 600, 1), (24, 601, 7), (130, 64, 2), (811, 16, 1), (1000, 16, 1), (1, 8, 1),
]


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def rel(a, b):
    return abs(a - b) / abs(b)


def rel_norm(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def kernel_inputs(gen, nx, nt, ntrials, device):
    qs = torch.linalg.qr(torch.randn(nx, nx, generator=gen, dtype=torch.float64))[0]
    qt = torch.linalg.qr(torch.randn(nt, nt, generator=gen, dtype=torch.float64))[0]
    dinv = 0.5 + 1.5 * torch.rand(nx, nt, generator=gen, dtype=torch.float64)
    Y = torch.randn(ntrials, nx, nt, generator=gen, dtype=torch.float64)
    return [a.contiguous().to(device) for a in (qs, qt, dinv, Y)]


def cuda_ms(fn, iters):
    """Mean milliseconds per call by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=50, replays=5):
    """Mean device milliseconds per call: ``calls`` calls captured in one
    CUDA graph, its replays timed with CUDA events, after a warm-up on a
    side stream as capture requires."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def sass_counts(lib, cuobjdump):
    """Instruction counts in the library's SASS: FP64 tensor-core MMAs,
    cp.async and TMA loads, and scalar FP64 FMAs."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("DMMA", "LDGSTS", "UTMALDG", "DFMA")}


def phase_kernel(qf, dev):
    """Kernel vs plain version: value rtol 1e-12, gradients 1e-10 (f64,
    another summation order).  Returns the max abs value error."""
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    for shape in KERNEL_SHAPES:
        ins = kernel_inputs(gen, *shape, dev)
        got = float(qf.quadform_cuda(*ins))
        again = float(qf.quadform_cuda(*ins))
        want = float(qf.quadform_reference(*ins))
        torch.cuda.synchronize()
        check(rel(got, want) <= 1e-12, f"quadform value {shape}: {got} vs {want}")
        check(again == got, f"quadform {shape}: two calls differ ({got} vs {again})")
        worst = max(worst, abs(got - want))
        a = [t.clone().requires_grad_() for t in ins]
        b = [t.clone().requires_grad_() for t in ins]
        ga = torch.autograd.grad(qf.quadform(*a), a[:3])
        gb = torch.autograd.grad(qf.quadform_reference(*b), b[:3])
        gerr = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(ga, gb))
        check(gerr <= 1e-10, f"quadform gradient {shape}: rel err {gerr}")
        emit("kernel", shape=list(shape), value=got, plain=want,
             rel_err=rel(got, want), grad_rel_err=gerr)
    return worst


def main():
    check(torch.cuda.is_available(), "CUDA is not available: this check needs a GPU")
    sys.path.insert(0, ROOT)
    from gpcsd_tpu_torch import paper
    from gpcsd_tpu_torch.infer.map import sample_restarts, value_and_grad
    from gpcsd_tpu_torch.ops.cuda import quadform as qf

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", torch=torch.__version__, cuda=torch.version.cuda, name=name,
         count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    lib = qf.build()
    seconds = time.perf_counter() - t0
    ptxas = [ln for ln in lib.with_suffix(".log").read_text().splitlines() if "ptxas" in ln]
    sass = sass_counts(lib, qf.cuda_tool("cuobjdump"))
    emit("build", seconds=seconds, library=os.path.relpath(lib, ROOT), ptxas=ptxas, sass=sass)
    check(sass["DMMA"] > 0, "the kernel library holds no FP64 tensor-core (DMMA) instruction")
    check(sass["LDGSTS"] + sass["UTMALDG"] > 0, "the kernel library holds no async copy")

    max_abs_err = phase_kernel(qf, dev)

    # ---- the main path: counts from here to the end of the fit
    lfp, time_ms, _ = paper.paper_surrogate(0, 1200, 100, device=dev)
    draws = np.load(os.path.join(HETX, "posterior_samples.npz"))["raw_u"].reshape(-1, 30)[:8]
    banked = np.load(os.path.join(HETX, "logp64_draws.npy"))[:8]
    gpu = paper.build_model(lfp, time_ms, het_noise="exact", device=dev)
    cpu = paper.build_model(lfp, time_ms, het_noise="exact", device="cpu")
    gfns, gY = gpu._fns(), gpu._Y()
    cfns, cY = cpu._fns(), cpu._Y()
    qf.launch_count = 0
    worst = {"banked": 0.0, "cpu_value": 0.0, "cpu_grad": 0.0, "cpu_grad_temporal": 0.0}
    for u, want in zip(draws, banked):
        v, g = value_and_grad(lambda ut: gfns.log_prob(ut, gY), u, dev)
        vc, gc = value_and_grad(lambda ut: cfns.log_prob(ut, cY), u, "cpu")
        check(np.isfinite(v) and np.all(np.isfinite(g)), "non-finite log_prob on the card")
        worst["banked"] = max(worst["banked"], rel(v, want))
        worst["cpu_value"] = max(worst["cpu_value"], rel(v, vc))
        worst["cpu_grad"] = max(worst["cpu_grad"], rel_norm(g, gc))
        worst["cpu_grad_temporal"] = max(worst["cpu_grad_temporal"], rel_norm(g[2:6], gc[2:6]))
    launches_log_prob = qf.launch_count
    emit("log_prob", draws=len(draws), launches=launches_log_prob, **worst)
    check(worst["banked"] <= 1e-8, "log_prob vs banked logp64_draws.npy above 1e-8")
    check(worst["cpu_value"] <= 1e-9, "log_prob CUDA vs CPU above 1e-9")
    # the spatial (R, ell, noise) components carry ~1e-5 of eigensolver-
    # dependent regularization bias; the temporal ones do not
    check(worst["cpu_grad"] <= 1e-4, "gradient CUDA vs CPU above 1e-4 in norm")
    check(worst["cpu_grad_temporal"] <= 1e-6, "temporal gradient CUDA vs CPU above 1e-6")
    check(launches_log_prob > 0, "the log-joint did not go through the quadform kernel")
    emit("launch_count", launches=launches_log_prob)

    t0 = time.perf_counter()
    res = gpu.fit(n_restarts=2, backend="scipy", seed=0, options={"maxiter": 10})
    fit_s = time.perf_counter() - t0
    launches = qf.launch_count
    # ---- end of the main path
    u0s = sample_restarts(gfns.param_set, np.random.default_rng(0), 2)
    nll0 = np.array([value_and_grad(lambda ut: gfns.neg_log_joint(ut, gY), u, dev)[0] for u in u0s])
    emit("fit", seconds=fit_s, nll_start=nll0.tolist(), nll_end=res.nll_values.tolist(),
         nll_best=res.nll_best, messages=res.messages)
    check(np.isfinite(res.nll_best), "MAP fit: best NLL is not finite")
    check(np.all(res.nll_values <= nll0), "MAP fit: a restart ended above its start")

    # ---- timing
    bench = bench_model(dev)
    bfns, bY = bench._fns(), bench._Y()
    u0 = bfns.param_set.pack(bench._theta()).cpu().numpy()
    us = u0[None, :] + 0.01 * np.random.default_rng(1).normal(size=(50, u0.size))
    for u in us[:3]:
        value_and_grad(lambda ut: bfns.neg_log_joint(ut, bY), u, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for u in us:
        value_and_grad(lambda ut: bfns.neg_log_joint(ut, bY), u, dev)
    torch.cuda.synchronize()
    evals_per_s = len(us) / (time.perf_counter() - t0)
    with torch.no_grad():
        theta = bfns.param_set.unpack(torch.as_tensor(u0, device=dev))
        factor_ms = cuda_ms(lambda: bfns.build_factors(theta), 20)
        value_ms = cuda_ms(lambda: bfns.loglik(theta, bY), 20)

    ins = kernel_inputs(torch.Generator().manual_seed(1), *KERNEL_SHAPES[0], dev)
    kernel = lambda: qf.quadform_cuda(*ins)  # noqa: E731
    plain = lambda: qf.quadform_reference(*ins)  # noqa: E731
    # in turns, plain-kernel-kernel-plain, so drift between them cancels
    dev_runs = [graph_ms(f) for f in (plain, kernel, kernel, plain)]
    eager_runs = [cuda_ms(f, 50) for f in (plain, kernel, kernel, plain)]
    device_ms, plain_device_ms = np.mean(dev_runs[1:3]), np.mean(dev_runs[::3])
    kernel_ms, plain_ms = np.mean(eager_runs[1:3]), np.mean(eager_runs[::3])
    emit("timing", card=smi, log_joint_value_grad_evals_per_s=evals_per_s,
         covariances_and_eighs_ms=factor_ms, loglik_value_ms=value_ms,
         quadform_device_ms=device_ms, quadform_plain_device_ms=plain_device_ms,
         quadform_ms=kernel_ms, quadform_plain_ms=plain_ms,
         quadform_device_ms_runs=dev_runs[1:3], quadform_plain_device_ms_runs=dev_runs[::3],
         quadform_ms_runs=eager_runs[1:3], quadform_plain_ms_runs=eager_runs[::3],
         shape=list(KERNEL_SHAPES[0]))

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "quadform", "route": "cuda",
        "source": "gpcsd_tpu_torch/csrc/quadform.cu",
        "replaces": "gpcsd_tpu/ops/pallas/quadform.py:32",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": device_ms, "plain_ms": plain_device_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


def bench_model(dev):
    """The JAX headline benchmark's point (``bench.py`` ``build_problem``):
    nx=24, nt=600, 100 trials, ngl=100, scalar noise."""
    from gpcsd_tpu_torch.models.gpcsd1d import GPCSD1D

    rng = np.random.default_rng(0)
    m = GPCSD1D(rng.normal(size=(24, 600, 100)), (np.arange(24) * 100.0).reshape(-1, 1),
                np.arange(600).reshape(-1, 1) * 1.0, ngl=100, device=dev)
    m.R["value"] = 150.0
    m.spatial_cov.params["ell"]["value"] = 200.0
    m.temporal_cov_list[0].params["ell"]["value"] = 8.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    m.temporal_cov_list[1].params["ell"]["value"] = 3.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
    m.sig2n["value"] = 0.05
    return m


if __name__ == "__main__":
    main()
