#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gpcsd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths.  The 1D path (covariances -> two float64
eighs -> Kronecker log-joint value and gradient through the hand-written
quadform kernel -> scipy L-BFGS-B MAP steps -> Laplace Hessian -> whitened
dense-metric NUTS with 4 chains -> R-hat/ESS -> predict) runs at the
auditory paper configuration: GPCSD1D, nx=24, nt=600, 100 trials, ngl=100,
SE + Matern-1/2, 24 per-channel noise variances, het_noise="exact".  The 2D
path (construct -> loglik -> L-BFGS batched over restarts on the card ->
predict -> predict_variance -> predict_samples -> sample_prior) runs at the
Neuropixels shape (``gpcsd_tpu_torch.paper.neuropixels_problem``): GPCSD2D,
nx=69 on the staggered 4-column geometry, nt=375, 100 trials, a 30 x 120
quadrature rule (3600 nodes), eps=1, scalar noise, 8 parameters.  After
them, the paper's analysis stages (band-pass phases, torus graph and its
bootstrap, per-trial shifts) and the twins of the ``auditory_lfp`` and
``fit_mean_function`` workloads run at those workloads' full width, then
the real-data modes on files the script writes, and the other five twins
(``simple_template_1d``, ``sim_from_gp_1d``, the mismatch study,
``sim_from_gp_2d``, ``neuropixels``) at their JAX defaults, and the
trial-sharded log-joint and the sharded drivers over ``torch.distributed``
at the paper configuration.
Phases, one JSON line each:

1. device: torch/CUDA versions and the card's name and power limit;
2. build: compile ``gpcsd_tpu_torch/csrc/quadform.cu`` and
   ``eigh_jacobi.cu`` into one library for sm_90a; print
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
7. timing: the covariances' and the value's milliseconds at the JAX bench
   point (its evals/s is phase 32's), and the kernel vs its plain version at the main-path shape, both as device time
   (50 calls captured in one CUDA graph, replays timed with events: no
   host launch cost) and as eager calls timed with events;
8. predict: ``GPCSD1D.predict(x, t[::4], type="both")`` with the
   parameters at the mean of the banked draws, card vs CPU;
9. hessian: ``laplace_hessian`` at that centre (60 gradients in one batched
   call), card vs CPU, and ``H^-1`` against the banked draws' covariance;
10. nuts: ``sample_posterior`` (4 chains, dense metric pooled over chains
   as in the banked run, whitened by that Hessian, max_depth 7) from that
   centre: health, launch count against the sampler's own leapfrog count,
   moments against the banked posterior, ms per batched leapfrog and the
   device's busy share under the profiler;
11. log_prob_2d: ``GPCSD2D.loglik()`` and value and gradient of ``log_prob``
   at the Neuropixels point and 4 jittered points, card vs the port on the
   CPU, and the batched ``(C, dim)`` call vs the unbatched one on the card;
12. fit_2d: ``GPCSD2D.fit(n_restarts=4, backend="torch")`` for 8 iterations:
   every restart finite and no higher than its start, launches against the
   optimizer's own count of evaluations, host reads, seconds, peak device
   memory; one scipy restart for its seconds per evaluation;
13. predict_2d: ``predict``, ``predict_variance`` (CSD and LFP) and
   ``predict_samples`` (random Fourier features, chosen by itself) at 4
   mid-line depths, card vs CPU; ``sample_prior``;
14. timing_2d: value+grad evals/s in 2D, the kernel vs its plain version and
   its bound at (69, 375, 100), and from ``torch.profiler`` the device time
   per evaluation and its largest kernels (printed last, measured in part
   before the 1D posterior phases, the profile after them);
15. reparam: ``AmplitudeReparam`` at the 8 banked draws: the round trip,
   ``log_prob_v(T(u))`` against ``log_prob(u)``, and card vs CPU;
16. advi: ``advi_fit`` for 12 steps at ``n_mc=8`` from the banked centre:
   every ELBO finite, launches = steps x n_mc, the first ELBO card vs CPU on
   the same draws, ms per step;
17. smc: ``smc_run`` on the model's ``log_prior_u`` / ``loglik`` from 32
   prior particles, 2 mutation steps, at most 4 stages: temperatures rising,
   evidence finite, launches = N x (1 + stages x mutation steps), the first
   stage card vs CPU, host reads per stage, ms per particle evaluation;
18. ic: ``information_criteria(max_draws=32)`` on the nuts phase's posterior:
   WAIC and PSIS-LOO finite, the largest Pareto k, and the pointwise terms
   summed over trials against ``loglik`` through the kernel;
19. paper_run: the paper run (``gpcsd_tpu_torch.paper_run.main``, the
   function behind ``scripts/torch_paper_nuts_run.py``) at short lengths,
   four times: stopped by ``--max-seconds`` inside the MAP stage and then in
   the sampler (exit code 3 each), finished from the saved state, and
   uninterrupted on the same cached inputs; the two sets of draws are equal
   bit for bit, the resumed MAP equals an uninterrupted MAP stage's, and the
   artifact holds every key;
20. signal: the auditory twin's two surrogate probes at full width (24
   channels, 400 samples, 60 trials), models restored by its ``fit_probe``
   from a pickle of fixed parameters, CSD and LFP predicted on the 199-sample
   trial window; ``bandpass_filtfilt`` 8-12 Hz, ``instantaneous_phase``,
   ``plv_matrix``, ``periodogram``: ms per call, card vs scipy and vs the
   port on the CPU, phases through exp(i phi);
21. torus: a well-posed torus graph (d=8, n=4000) and the auditory one on
   the signal phase's phases (d=48, n=60), card vs CPU; the bootstrap of
   200 replicates at d=48: ms per replicate, peak memory, replicates vs the
   fit on their trials;
22. shifts: the per-trial kernel (``quadform_rows``) against its plain
   version per trial, its sum against the scalar kernel, its gradients and
   a repeat call at (24, 60, 40) (line ``kernel_rows``); then
   ``estimate_shifts`` at fit_mean_function's default shape from one model
   fitted on the card: card vs CPU, and per-trial kernel launches equal to
   the stage's batched evaluations (calls of ``shift_nll``), none of the
   scalar kernel;
23. workloads: both workload twins' ``run()`` on the card at full width
   (restarts cut to 3): seconds per stage, the JAX tests' thresholds,
   launches by shape, the shift stage's launches as in phase 22;
24. io: the native parser built on this host (else the script fails), the
   auditory twin's surrogate written in the reference's text format (2
   probes x 24 electrodes, 400 samples, 60 trials), loaded cold and from
   its ``.npy`` cache, equal to the written arrays and, parsed natively, to
   ``np.loadtxt`` bit for bit; then the real-data modes on those files:
   ``auditory_lfp.run(data_dir=)`` (its figures drawn where matplotlib
   imports, else one line says which was skipped),
   ``fit_mean_function.run_real`` with the stage-1 pickles that run wrote
   (its shift stage's seconds, and launches checked as in phase 22), and
   ``neuropixels.run(data_dir=)`` on two
   pickles in ``extract_probe``'s schema at ngl 10 x 30 (restarts, ngl and
   nboot cut, each cut printed);
25. workloads_sim: ``simple_template_1d``, ``sim_from_gp_1d`` (fit and
   oracle, each with the kCSD protocol) and the mismatch study (three fits,
   two 128-particle SMC runs, PSIS-LOO) at their JAX defaults: seconds per
   stage, launches by shape, SMC stages and last temperature, the JAX
   tests' thresholds;
26. workloads_2d: ``sim_from_gp_2d`` and the Neuropixels twin (20 restarts,
   ngl 30 x 120, nt 150, 40 trials, 4 x 1000 bootstrap replicates) at their
   JAX defaults: seconds per stage, peak device memory, trials kept, the
   JAX tests' thresholds;
27. timing_analysis and timing_new_shapes: the kernel vs its plain version
   at the shapes the analysis stages and the other twins give it (device
   time, CUDA graph of 50 calls), each new shape first checked as in
   phase 3; timing_rows: the per-trial kernel the same way, with its bound,
   at the two shift stages' full batches (24, 60, 40) and (24, 151, 60),
   the second first checked as in phase 22;
28. parallel (``gpcsd_tpu_torch/parallel/``, run before phase 27): (a)
   ``parallel_ws1``, a process group of one rank over NCCL and the default
   mesh: the trial-sharded value+grad at the banked centre and 3 jitters
   against ``log_prob`` (bit for bit), its ms beside the unsharded ms, the
   collectives' ms, ``sample_posterior(mesh=)`` 2 x (5 + 5) from prior draws
   and ``advi(mesh=)`` against ``advi()``; (b) ``parallel_ranks``, two ranks
   spawned on the one card over gloo with CUDA tensors (NCCL takes one rank
   per GPU): at (chain=1, trial=2) the value+grad against the unsharded one
   and against the two blocks' terms summed in one process, the collectives'
   ms through the host, ``map_fit_sharded`` 2 x 10 and ``advi_sharded`` 12 x 8;
   at (2, 1) ``map_fit_sharded``, ``smc_sharded`` (32 particles, 3 stages)
   and ``nuts_sharded`` 2 x (3 + 3) against their unsharded twins; then the
   kernel at the block's shape (24, 600, 50) as in phase 3 and 27;
29. map_resume (after phase 6): ``fit`` of 3 restarts x 12 L-BFGS
   iterations at the paper configuration, uninterrupted and stopped by
   ``options={"max_wall_seconds": 0, "chunk_iters": 3, "state_path": ...}``
   at every checkpoint and rerun until done: ``u``, NLLs and evaluations
   equal bit for bit; ms a checkpoint save and its bytes;
30. noise_probe (after phase 19): ``gpcsd_tpu_torch.noise_probe.probe`` at
   the banked posterior's centre, ``het_noise`` "exact" and "approx", card
   and CPU: the RMS residual of a quadratic fit to 33 values of log p over
   a segment of half-width 1e-2; on the card below 1e-2 log-units and
   within 10x the CPU's;
31. profiling: ``gpcsd_tpu_torch.utils.profiling`` at the bench point:
   ``measure_evals_per_second`` and ``Throughput`` over the bench's 50
   points beside the bench phase's evals/s (which keeps each value on the
   card; these read it to the host after every evaluation), and a ``trace`` of 3 value+grad
   evaluations whose Chrome trace names the quadform kernel;
32. bench (after phase 7): ``gpcsd_tpu_torch.bench``, the twin of
   ``bench.py``: value+grad evals/s over 5 repeats of its 50 distinct points
   (median, quartiles, CUDA events' ms per evaluation), the numpy baseline,
   the NUTS line from the banked port paper run (11.43 draws/s, 7.0
   leapfrogs, max_depth 7, chunk_size 1) and from the live 4 x (40 + 40)
   run forced with ``paths=[]``: launches = evaluations, the points
   distinct, the live line a rate with every gate passed or null with its
   reasons, its launches = the sampler's own count of evaluations plus the
   Hessian's rows;
33. bench_2d (after phase 14): ``bench_2d`` at the Neuropixels point, its
   numpy baseline, its last value card vs CPU within ``TOL_2D``'s value limit;
34. nuts_2d: the 2D probe's twin (``gpcsd_tpu_torch.nuts_2d_probe``) at full
   width in a temporary directory: ``--prep-only`` (surrogate and Laplace
   Hessian on the card; the Hessian against the CPU's within
   ``TOL_HESSIAN_2D``), then dense-mass NUTS 4 x (8 + 6) at max_depth 6 from
   the generating point: launches at (69, 375, 100) = the sampler's own count
   of evaluations, the rate null exactly when the health gate failed; health
   reported, not required;
35. noise_2d: ``noise_probe.probe`` on that surrogate at its generating point,
   card and CPU, 33 points each: values finite, RMS reported; then
   ``log_prob`` and its gradient card vs CPU on a second seed's surrogate at
   its generating point (line ``noise_2d_seed1``), reported;
36. eigh_jacobi (after phase 3; alone with ``python3 chip_smoke.py
   eigh_jacobi``, after phases 1-3): the batched block-Jacobi
   eigensolver (``gpcsd_tpu_torch/ops/cuda/eigh.py``) on the cells' ``Kt``
   (the auditory model's, n = 600, and the Neuropixels model's, n = 375) at
   prior-drawn hyperparameters, C = 1, 4, 10, 20 rows: eigenvalues,
   reconstruction and orthogonality against ``torch.linalg.eigh``, two calls
   bit for bit, sweeps a row and no unconverged row; the plain version at
   (2, 128) against the kernel; then its device ms (50 calls in one CUDA
   graph) and eager ms at the shapes of ``EIGH_TIMED`` beside the per-row
   ``torch.linalg.eigh`` loop the port ran before (``library_ms``), the
   bound (9 n^3 a row at 67 TFLOP/s), the cluster size chosen and the
   device ms at other cluster sizes; and, at C = 1 and 4 over
   ``EIGH_SMALL_N``, kernel against library, which sets
   ``kronlik.JACOBI_MIN_N``.

The quadform launch counts (the scalar kernel's and, apart from it, the
per-trial kernel's) are set to 0 before each stretch of the main path
(log_prob + fit, map_resume, bench, hessian, nuts, log_prob_2d, fit_2d,
bench_2d, nuts_2d's prep and its sampling, noise_2d, reparam,
advi, smc, ic, paper_run, noise_probe, profiling, the shifts phase's fit and
its shift stage, workloads, each
twin's run in io, workloads_sim and workloads_2d, and each sharded call of
the parallel phase, in this process and in each rank) and read after it;
``predict`` and the other outputs solve with the factors and launch no
kernel.  The ``eigh_jacobi`` launch counts, by the order of the matrices,
are set to 0 before the same stretches (and before phase 36, predict,
predict_2d, nuts_2d as a whole, shifts as a whole and parallel_ws1), and
each rank reports its own; the log_prob stretch (its draws as one batch,
beside the single draws, whose ``Kt`` of 600 goes to cuSOLVER alone),
map_resume, nuts and fit_2d must each have launched the kernel at their
``Kt``'s order (line ``eigh_jacobi_launches``; the kernel table's rows).  Any failure raises and the script
exits non-zero.  Without CUDA, or run outside a checkout of the repository,
it fails before printing a result.
"""

import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HETX = os.path.join(ROOT, "results", "paper_nuts_hetx")
#: NUTS phase: transitions per chain (the whole script stays under 300 s)
NUTS_WARMUP, NUTS_SAMPLES, NUTS_CHAINS, NUTS_MAX_DEPTH = 40, 30, 4, 7
#: H100 SXM data-sheet peaks used for the kernel's bound
PEAK_FP64_TENSOR_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
#: the shapes the two main paths give the kernel: (nx, nt, ntrials)
SHAPE_1D, SHAPE_2D = (24, 600, 100), (69, 375, 100)
NT_1D, NT_2D = SHAPE_1D[1], SHAPE_2D[1]  #: the orders of their temporal factors
#: the shapes the analysis stages give it: the auditory twin's fit (200
#: baseline samples of 400, 60 trials) and fit_mean_function's fit; and one
#: trial at the shift stage's width (the shift stage itself goes through the
#: per-trial kernel, at :data:`SHAPE_ROWS_SHIFT`)
SHAPE_AUD, SHAPE_FMF, SHAPE_SHIFT = (24, 200, 60), (24, 60, 40), (24, 60, 1)
#: the shapes the remaining twins give it at their defaults: sim_from_gp_1d's
#: fit, the mismatch study's fits and SMC, sim_from_gp_2d's fit (a 4 x 25
#: grid), simple_template_1d's fits (one trial), and the real-data evoked
#: twin's shift stage width (151 samples of the 0-150 ms window) at one
#: trial; the Neuropixels twin's (36 sites, 150 samples, the trials its
#: outlier rejection keeps) is known after its run
SHAPE_SIM1D, SHAPE_MISMATCH, SHAPE_SIM2D = (24, 60, 100), (24, 50, 50), (100, 30, 3)
SHAPE_TEMPLATE, SHAPE_REAL_SHIFT = (24, 50, 1), (24, 151, 1)
#: the per-trial kernel's shapes at the shift stages' first batched
#: evaluation (all trials; later ones take the trials still searching):
#: fit_mean_function's 40 trials, and the real-data twin's 60 (the io
#: phase's written files) at 151 samples
SHAPE_ROWS_SHIFT, SHAPE_ROWS_REAL = (24, 60, 40), (24, 151, 60)
NPX_NX, NPX_NT = 36, 150
#: the eigensolver's timed shapes (rows, n): the cells' rows a pass
EIGH_TIMED = [(4, 600), (10, 600), (20, 600), (4, 375), (20, 375), (1, 600)]
#: the orders at which kernel and library are compared for the small-n switch
EIGH_SMALL_N = [24, 30, 40, 60, 100, 151, 200, 256, 300, 375]
KERNEL_SHAPES = [
    SHAPE_1D, SHAPE_2D, SHAPE_AUD, SHAPE_FMF, SHAPE_SHIFT, SHAPE_SIM1D, SHAPE_MISMATCH,
    SHAPE_SIM2D, SHAPE_TEMPLATE, SHAPE_REAL_SHIFT, (7, 129, 3), (69, 375, 5),
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


def check_kernel(qf, shape, dev, gen):
    """Kernel vs plain version at ``shape``: value rtol 1e-12, gradients
    1e-10 (f64, another summation order), two calls bit-equal.  Returns the
    abs value error."""
    ins = kernel_inputs(gen, *shape, dev)
    got = float(qf.quadform_cuda(*ins))
    again = float(qf.quadform_cuda(*ins))
    want = float(qf.quadform_reference(*ins))
    torch.cuda.synchronize()
    check(rel(got, want) <= 1e-12, f"quadform value {shape}: {got} vs {want}")
    check(again == got, f"quadform {shape}: two calls differ ({got} vs {again})")
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    ga = torch.autograd.grad(qf.quadform(*a), a[:3])
    gb = torch.autograd.grad(qf.quadform_reference(*b), b[:3])
    gerr = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(ga, gb))
    check(gerr <= 1e-10, f"quadform gradient {shape}: rel err {gerr}")
    emit("kernel", shape=list(shape), value=got, plain=want,
         rel_err=rel(got, want), grad_rel_err=gerr)
    return abs(got - want)


def check_rows_kernel(qf, shape, dev, gen):
    """The per-trial kernel (``quadform_rows``) vs its plain version at
    ``shape``: every trial to 1e-12 relative, the sum to 1e-13 of the scalar
    kernel on the same inputs, gradients under a cotangent that weights the
    trials differently to 1e-10, two calls bit-equal.  Returns the largest
    abs error over the trials."""
    ins = kernel_inputs(gen, *shape, dev)
    got = qf.quadform_rows_cuda(*ins)
    again = qf.quadform_rows_cuda(*ins)
    want = qf.quadform_rows_reference(*ins)
    total = float(qf.quadform_cuda(*ins))
    torch.cuda.synchronize()
    err = float(torch.max(torch.abs(got - want) / torch.abs(want)))
    sum_err = rel(float(got.sum()), total)
    check(tuple(got.shape) == (shape[2],) and err <= 1e-12,
          f"quadform_rows {shape}: rel err {err} against the plain version")
    check(torch.equal(got, again), f"quadform_rows {shape}: two calls differ")
    check(sum_err <= 1e-13, f"quadform_rows {shape}: sum vs the scalar kernel {sum_err}")
    w = torch.linspace(-1.0, 2.0, shape[2], dtype=torch.float64, device=dev)
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    ga = torch.autograd.grad((qf.quadform_rows(*a) * w).sum(), a)
    gb = torch.autograd.grad((qf.quadform_rows_reference(*b) * w).sum(), b)
    gerr = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(ga, gb))
    check(gerr <= 1e-10, f"quadform_rows gradient {shape}: rel err {gerr}")
    emit("kernel_rows", shape=list(shape), rel_err=err, sum_rel_err_vs_scalar=sum_err,
         grad_rel_err=gerr, bit_equal_repeat=True)
    return float(torch.max(torch.abs(got - want)))


class ShiftStageCount:
    """Counts, from 0, the shift stage's batched evaluations (calls of
    ``models.shifts.shift_nll``, which ``estimate_shifts`` makes once per
    batched value-and-gradient) and the per-trial kernel's launches, while
    the ``with`` block runs; the scalar kernel's counts are set to 0 too."""

    def __init__(self, qf):
        self.qf = qf

    def __enter__(self):
        from gpcsd_tpu_torch.models import shifts

        self.shifts, self.shift_nll = shifts, shifts.shift_nll
        self.calls = 0

        def counted(*args, **kwargs):
            self.calls += 1
            return self.shift_nll(*args, **kwargs)

        shifts.shift_nll = counted
        self.qf.launch_count = self.qf.rows_launch_count = 0
        self.qf.launches_by_shape.clear()
        self.qf.rows_launches_by_shape.clear()
        return self

    def __exit__(self, *exc):
        self.shifts.shift_nll = self.shift_nll
        self.scalar_launches = self.qf.launch_count
        self.scalar_by_shape = dict(self.qf.launches_by_shape)
        self.launches = self.qf.rows_launch_count
        self.by_shape = dict(self.qf.rows_launches_by_shape)
        return False

    def check(self, phase, nx, nt, ntrials):
        """Rows launches = batched evaluations > 0, each at (nx, nt, B) with
        B <= ntrials, and none of the scalar kernel at (nx, nt, 1)."""
        check(self.launches == self.calls > 0,
              f"{phase}: {self.launches} quadform_rows launches for {self.calls} batched evaluations")
        check(all(k[:2] == (nx, nt) and k[2] <= ntrials for k in self.by_shape),
              f"{phase}: quadform_rows shapes {self.by_shape}")
        check(self.scalar_by_shape.get((nx, nt, 1), 0) == 0,
              f"{phase}: the scalar kernel ran at the shift shape {self.scalar_by_shape}")

    def summary(self):
        return {"rows_launches": self.launches, "batched_evaluations": self.calls,
                "rows_launches_by_batch": {str(k[2]): v for k, v in sorted(self.by_shape.items())}}


def eigh_inputs(dev, rows, which, seed=0):
    """``Kt`` of ``rows`` prior-drawn parameter rows of the cell's model
    (``which``: "auditory", n = 600, or "neuropixels", n = 375), or of the
    auditory model's temporal kernels on an n-sample grid (``which`` an
    int n)."""
    from gpcsd_tpu_torch import paper
    from gpcsd_tpu_torch.infer.map import sample_restarts

    key = "neuropixels" if which == "neuropixels" else "auditory"
    if key not in _EIGH_MODELS:
        if key == "auditory":
            lfp, time_ms, _ = paper.paper_surrogate(0, 1200, 100, device=dev)
            _EIGH_MODELS[key] = paper.build_model(lfp, time_ms, het_noise="exact", device=dev)._fns()
        else:
            _EIGH_MODELS[key] = paper.neuropixels_problem(0, device=dev)._fns()
    fns = _EIGH_MODELS[key]
    u = torch.tensor(sample_restarts(fns.param_set, np.random.default_rng(seed), rows), device=dev)
    if isinstance(which, str):
        return fns.graphs.inputs_half(u)[1].detach().contiguous()
    theta = fns.full_theta(fns.param_set.unpack(u))
    t = torch.arange(which, dtype=torch.float64, device=dev)
    return fns.build_kt(theta, t=t, tprime=t).detach().contiguous()


_EIGH_MODELS = {}


def eigh_errors(a, w, v):
    """Largest over rows: eigenvalue gap to ``torch.linalg.eigh`` over
    ||A||_F, reconstruction error over ||A||_F, largest |V^T V - I|."""
    wr = torch.linalg.eigh(a)[0]
    nrm = torch.linalg.matrix_norm(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return {"eig": float(((w - wr).abs().amax(-1) / nrm).max()),
            "rec": float((torch.linalg.matrix_norm(v @ torch.diag_embed(w) @ v.mT - a) / nrm).max()),
            "orth": float((v.mT @ v - eye).abs().amax())}


def library_loop_ms(a, iters=3):
    """ms a call of the per-row ``torch.linalg.eigh`` loop the port ran
    before (each call syncs on its error flag)."""
    return cuda_ms(lambda: [torch.linalg.eigh(x) for x in a], iters)


def phase_eigh_jacobi(dev, smi):
    """The batched eigensolver on the cells' ``Kt``: checks, times, the
    small-n switch (docstring, phase 36).  Returns the kernel table rows."""
    from gpcsd_tpu_torch.ops import kronlik
    from gpcsd_tpu_torch.ops.cuda import eigh as ej

    worst = {"eig": 0.0, "rec": 0.0, "orth": 0.0}
    sweeps = {}
    for which, n in (("auditory", 600), ("neuropixels", 375)):
        for rows in (1, 4, 10, 20):
            a = eigh_inputs(dev, rows, which, seed=rows)
            ej.stats(reset=True)
            w, v = ej.eigh_jacobi_cuda(a)
            st = ej.stats(reset=True)
            w2, v2 = ej.eigh_jacobi_cuda(a)
            torch.cuda.synchronize()
            check(torch.equal(w, w2) and torch.equal(v, v2), f"eigh_jacobi ({rows}, {n}): two calls differ")
            check(st["unconverged"] == 0, f"eigh_jacobi ({rows}, {n}): {st['unconverged']} rows unconverged")
            errs = eigh_errors(a, w, v)
            emit("eigh_jacobi_check", rows=rows, n=n, sweeps_per_row=st["sweeps"] / rows,
                 cluster=ej.cluster_size(rows, n, dev), **errs)
            sweeps[(rows, n)] = st["sweeps"] / rows
            for k in worst:
                worst[k] = max(worst[k], errs[k])
    # every cluster size on the MAP cell's first pass: CTAs with several pairs
    a = eigh_inputs(dev, 10, "auditory", seed=2147483713)
    for k in (1, 2, 4, 8, 16):
        errs = eigh_errors(a, *ej.eigh_jacobi_cuda(a, cluster=k))
        emit("eigh_jacobi_check", rows=10, n=600, cluster=k, **errs)
        for key in worst:
            worst[key] = max(worst[key], errs[key])
    check(worst["eig"] <= 1e-12, f"eigh_jacobi eigenvalues off by {worst['eig']} of ||A||")
    check(worst["rec"] <= 1e-12, f"eigh_jacobi reconstruction off by {worst['rec']} of ||A||")
    check(worst["orth"] <= 1e-11, f"eigh_jacobi V^T V - I up to {worst['orth']}")

    # the plain version on the card at a small shape (it runs op by op)
    a = eigh_inputs(dev, 2, 128, seed=5)
    info = {}
    t0 = time.perf_counter()
    wp, vp = ej.eigh_jacobi_reference(a, info=info)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    wk, vk = ej.eigh_jacobi_cuda(a)
    gap = float(((wk - wp).abs().amax(-1) / torch.linalg.matrix_norm(a)).max())
    emit("eigh_jacobi_plain", rows=2, n=128, plain_ms=1e3 * plain_s, sweeps=info["sweeps"],
         kernel_vs_plain_eig=gap, **eigh_errors(a, wp, vp))
    check(gap <= 1e-12, f"eigh_jacobi kernel vs plain version: eigenvalues off by {gap}")

    rows_out = []
    for rows, n in EIGH_TIMED:
        a = eigh_inputs(dev, rows, "auditory" if n == 600 else "neuropixels", seed=100 + rows)
        before = ej.launch_count
        k = ej.cluster_size(rows, n, dev)
        device_ms = graph_ms(lambda: ej.eigh_jacobi_cuda(a), calls=10, replays=3)
        eager_ms = cuda_ms(lambda: ej.eigh_jacobi_cuda(a), 5)
        by_cluster = {}
        for kk in sorted({2, 4, 8, 12, 16, k}):
            if kk <= min(ej._ready(dev).eigh_jacobi_f64_max_cluster(), ej.padded_order(n) // ej.TILE):
                by_cluster[kk] = cuda_ms(lambda: ej.eigh_jacobi_cuda(a, cluster=kk), 3)
        lib_ms = library_loop_ms(a)
        bound_ms = rows * 9.0 * n ** 3 / PEAK_FP64_TENSOR_FLOPS * 1e3
        row = {"rows": rows, "n": n, "ms": device_ms, "eager_ms": eager_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "cluster": k, "ms_by_cluster": by_cluster,
               "sweeps_per_row": sweeps.get((rows, n)), "launches": ej.launch_count - before,
               "card": smi}
        emit("eigh_jacobi_timing", **row)
        rows_out.append(row)

    small = {}
    for n in EIGH_SMALL_N:
        for rows in (1, 4):
            a = eigh_inputs(dev, rows, n, seed=n)
            errs = eigh_errors(a, *ej.eigh_jacobi_cuda(a))
            check(errs["rec"] <= 1e-12 and errs["eig"] <= 1e-12, f"eigh_jacobi ({rows}, {n}): {errs}")
            small[(rows, n)] = (cuda_ms(lambda: ej.eigh_jacobi_cuda(a), 5), library_loop_ms(a, 5))
            emit("eigh_jacobi_small_n", rows=rows, n=n, kernel_ms=small[(rows, n)][0],
                 library_ms=small[(rows, n)][1], **errs)
    faster = {r: [n for n in EIGH_SMALL_N if small[(r, n)][0] < small[(r, n)][1]] for r in (1, 4)}
    emit("eigh_jacobi_switch", kernel_faster_at_1_row=faster[1], kernel_faster_at_4_rows=faster[4],
         jacobi_min_n=kronlik.JACOBI_MIN_N, jacobi_max_n_alone=kronlik.JACOBI_MAX_N_ALONE)
    return rows_out


def phase_kernel(qf, dev):
    """:func:`check_kernel` at every shape of :data:`KERNEL_SHAPES`.
    Returns the abs value error by shape."""
    gen = torch.Generator().manual_seed(0)
    return {shape: check_kernel(qf, shape, dev, gen) for shape in KERNEL_SHAPES}


def max_rel(a, b):
    """Largest absolute difference over the largest magnitude of ``b``."""
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def quadform_bound_ms(nx, nt, ntrials, per_trial=False):
    """Least milliseconds the card could take for one quadform call: the
    larger of its operations (the two products ``Qs^T Y_b`` and ``(.) Qt``)
    at the FP64 tensor-core peak and its bytes (Y, Qt, Qs, dinv read once,
    one scalar written, or one per trial for ``quadform_rows``) at the
    memory rate."""
    ops = 2.0 * ntrials * nx * nt * (nt + nx)
    nbytes = 8.0 * (ntrials * nx * nt + nt * nt + nx * nx + nx * nt + (ntrials if per_trial else 1))
    t_ops, t_bytes = ops / PEAK_FP64_TENSOR_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def set_params(model, u):
    """Write the unconstrained vector ``u`` into the model's parameters."""
    fns = model._fns()
    model._set_theta(fns.param_set.unpack(torch.tensor(u, device=model.device)))


def phase_predict(gpu, cpu, time_ms):
    """predict on the card against the port on the CPU: rel. error <= 1e-9
    in the max norm (two float64 eigensolvers behind the same solve)."""
    t_sub = time_ms[time_ms < 0][::4]
    t0 = time.perf_counter()
    gpu.predict(gpu.x, t_sub, type="both")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cpu.predict(cpu.x, t_sub, type="both")
    shape = (gpu.x.shape[0], t_sub.size, gpu.lfp.shape[2])
    errs = {}
    for name in ("csd_pred", "lfp_pred"):
        got, want = getattr(gpu, name), getattr(cpu, name)
        check(got.shape == shape, f"predict: {name} has shape {got.shape}, expected {shape}")
        check(np.all(np.isfinite(got)), f"predict: {name} is not finite")
        errs[name] = max_rel(got, want)
        for i, (a, b) in enumerate(zip(getattr(gpu, name + "_list"), getattr(cpu, name + "_list"))):
            check(a.shape == shape, f"predict: {name}_list[{i}] has shape {a.shape}")
            errs[f"{name}_list{i}"] = max_rel(a, b)
    # how well the posterior-mean LFP at the electrodes reproduces the data
    resid = gpu.lfp_pred - gpu.lfp[:, ::4, :]
    emit("predict", seconds=seconds, shape=list(shape), rel_err_vs_cpu=errs,
         lfp_residual_rms=float(np.sqrt(np.mean(resid ** 2))),
         lfp_rms=float(np.sqrt(np.mean(gpu.lfp ** 2))))
    check(max(errs.values()) <= 1e-9, f"predict CUDA vs CPU above 1e-9: {errs}")


def phase_hessian(qf, gpu, cpu, u_center, banked_u):
    """Laplace Hessian on the card: finite, symmetric, positive definite
    after the floor, and against the CPU's: within 3e-4 of max|H|, and
    within 1e-8 on the temporal 4 x 4 block.  The stencil divides the two
    eigensolvers' gradient difference by 2h = 2e-4: ~1e-5 relative on the
    spatial and noise components (see the log_prob phase), so ~1e-4 of
    max|H| there, and ~1e-10 on the temporal ones.  On an H100 the readings
    are 1.014e-4 and 4.2e-10, the same in every run; each limit leaves a
    factor of 3 (25 on the temporal block) and no more."""
    from gpcsd_tpu_torch.models.inference_api import laplace_hessian, whitening_from_hessian

    qf.launch_count = 0
    t0 = time.perf_counter()
    H = laplace_hessian(gpu._fns(), u_center, gpu._Y())
    seconds = time.perf_counter() - t0
    launches = qf.launch_count
    t0 = time.perf_counter()
    H_cpu = laplace_hessian(cpu._fns(), u_center, cpu._Y())
    cpu_seconds = time.perf_counter() - t0
    w = np.linalg.eigvalsh(H)
    A, _ = whitening_from_hessian(H)
    wa = np.linalg.eigvalsh(A)
    cov_banked = np.cov(banked_u.T)
    diag_rel = np.abs(np.diag(np.linalg.inv(H)) / np.diag(cov_banked) - 1.0)
    emit("hessian", seconds=seconds, cpu_seconds=cpu_seconds, launches=launches,
         eig_min=float(w[0]), eig_max=float(w[-1]), whitening_eig_min=float(wa[0]),
         whitening_eig_max=float(wa[-1]), rel_err_vs_cpu=max_rel(H, H_cpu),
         rel_err_vs_cpu_temporal=float(np.abs(H - H_cpu)[2:6, 2:6].max() / np.abs(H_cpu).max()),
         inv_diag_vs_banked_cov_max_rel=float(diag_rel.max()))
    check(np.all(np.isfinite(H)), "hessian: non-finite entries")
    check(np.array_equal(H, H.T), "hessian: not symmetric")
    check(np.all(np.isfinite(A)) and wa[0] > 0, "hessian: whitening map is not positive definite")
    check(launches == 2 * u_center.size,
          f"hessian: {launches} quadform launches for {2 * u_center.size} stencil points")
    check(max_rel(H, H_cpu) <= 3e-4, "hessian CUDA vs CPU above 3e-4 of max|H|")
    check(np.abs(H - H_cpu)[2:6, 2:6].max() <= 1e-8 * np.abs(H_cpu).max(),
          "hessian CUDA vs CPU, temporal block, above 1e-8 of max|H|")
    return H, launches


def leapfrog_ms(gpu, us, calls=5):
    """Milliseconds per batched leapfrog of ``len(us)`` chains (host clock
    around synchronised calls, after one warm-up call)."""
    from gpcsd_tpu_torch.infer.hmc import leapfrog
    from gpcsd_tpu_torch.models.core import value_and_grad_rows

    fns, Y = gpu._fns(), gpu._Y()
    vg = lambda z: value_and_grad_rows(lambda u: fns.log_prob(u, Y), z)  # noqa: E731
    z = torch.tensor(us, device=gpu.device)
    r = torch.zeros_like(z)
    step = torch.full((z.shape[0],), 1e-6, dtype=z.dtype, device=z.device)
    _, grad = vg(z)
    leapfrog(vg, z, r, grad, step, torch.ones_like(z))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        leapfrog(vg, z, r, grad, step, torch.ones_like(z))
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def profiled_busy_share(gpu, H, transitions=3):
    """Device time over a few NUTS transitions of 4 chains, from
    ``torch.profiler``: the summed durations of the device's kernels and
    copies, per quadform launch (one launch is one chain's leapfrog) and as
    a share of the window's wall time.  The profiler's own cost inflates
    that wall time, so the caller also sets the device time per launch
    against the unprofiled phase's wall time per launch: an estimate
    (``device_busy_share_est``) from two different runs, not a reading of
    the phase itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gpcsd_tpu_torch.ops.cuda import quadform as qf

    kw = dict(n_chains=NUTS_CHAINS, num_warmup=0, num_samples=transitions, seed=1,
              max_depth=NUTS_MAX_DEPTH, laplace_hessian=H, dense_mass=True)
    torch.cuda.synchronize()
    before = qf.launch_count
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        post = gpu.sample_posterior(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) * 1e-6
    check(busy > 0, "the profiler recorded no device time")
    top = sorted(((e.key, getattr(e, "self_device_time_total", 0.0)) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), key=lambda kv: -kv[1])[:6]
    launches = qf.launch_count - before
    return {"busy_share_profiled": busy / wall, "wall_seconds": wall, "device_seconds": busy,
            "launches": launches, "device_ms_per_launch": 1e3 * busy / launches,
            "leapfrogs_sampling": int(post.diagnostics["num_steps"].sum()),
            "top_kernels_us": [[k[:40], v] for k, v in top]}


def phase_nuts(qf, gpu, H, u_center, banked_u, smi):
    """Whitened dense-metric NUTS from the banked posterior's centre."""
    qf.launch_count = 0
    t0 = time.perf_counter()
    post = gpu.sample_posterior(
        n_chains=NUTS_CHAINS, num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES, seed=0,
        max_depth=NUTS_MAX_DEPTH, init="params_jitter", laplace=True, laplace_hessian=H,
        dense_mass=True, pool_warmup=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = qf.launch_count
    res, d = post.raw, post.diagnostics
    u = res.samples.cpu().numpy()
    steps_sampling = int(d["num_steps"].sum())
    sd = banked_u.std(axis=0)
    z = (u.reshape(-1, u.shape[-1]).mean(axis=0) - banked_u.mean(axis=0)) / sd
    lf1 = leapfrog_ms(gpu, banked_u[:1])
    lf4 = leapfrog_ms(gpu, banked_u[:4])
    busy = profiled_busy_share(gpu, H)
    emit("nuts", card=smi, seconds=seconds, chains=NUTS_CHAINS, num_warmup=NUTS_WARMUP,
         num_samples=NUTS_SAMPLES, max_depth=NUTS_MAX_DEPTH, launches=launches,
         leapfrogs_sampling=steps_sampling,
         draws_per_s=NUTS_CHAINS * NUTS_SAMPLES / seconds,
         transitions_per_s=NUTS_CHAINS * (NUTS_WARMUP + NUTS_SAMPLES) / seconds,
         ms_per_launch=1e3 * seconds / launches,
         device_busy_share_est=busy["device_ms_per_launch"] / (1e3 * seconds / launches),
         leapfrogs_per_draw=steps_sampling / d["num_steps"].size,
         accept_mean=float(d["accept_prob"].mean()), step_size=d["step_size"].tolist(),
         divergent=int(d["diverging"].sum()), max_rhat=float(max(d["rhat"].values())),
         min_ess_bulk=float(min(d["ess"].values())), min_ess_tail=float(min(d["ess_tail"].values())),
         max_abs_z_vs_banked=float(np.abs(z).max()),
         leapfrog_ms_1_chain=lf1, leapfrog_ms_4_chains=lf4, profile=busy)
    check(np.all(np.isfinite(u)) and bool(torch.isfinite(res.logp).all()),
          "nuts: a sample or log-density is not finite")
    check(u.shape == (NUTS_CHAINS, NUTS_SAMPLES, u_center.size), f"nuts: samples have shape {u.shape}")
    check(launches >= steps_sampling,
          f"nuts: {launches} quadform launches for {steps_sampling} sampling leapfrogs")
    check(d["step_size"].min() >= 1e-3, f"nuts: a chain's step size collapsed: {d['step_size']}")
    check(d["diverging"].mean() <= 0.05, "nuts: over 5% of the sampling draws diverged")
    check(np.abs(z).max() <= 1.0,
          f"nuts: a parameter's mean is {np.abs(z).max():.2f} banked sd from the banked mean")
    return launches, post


# ------------------------------- the other engines and the paper run

#: lengths of the new phases
ADVI_STEPS, ADVI_N_MC = 12, 8
SMC_PARTICLES, SMC_MUTATIONS, SMC_MAX_STAGES = 32, 2, 4
#: the artifact's keys: those of the banked JAX run's JSON, with the device's
#: name and nvidia-smi line for ``backend`` / ``n_devices``, and the
#: verdicts (``vs_banked``, ``healthy`` and the health gate's failures)
ARTIFACT_KEYS = {
    "config", "device", "nvidia_smi", "samples_per_s_per_chip_median",
    "samples_per_s_per_chip_wall", "median_sampling_chunk_s", "median_warmup_chunk_s",
    "total_chunk_wall_s", "divergences", "mean_leapfrogs_per_sample", "mean_acceptance",
    "max_rhat", "min_ess", "min_ess_tail", "rhat", "ess", "ess_tail", "step_size",
    "posterior_mean", "posterior_sd", "truth", "posterior_quantiles", "vs_banked", "healthy",
    "gate_failures",
}


def phase_reparam(qf, gpu, cpu, draws):
    """The amplitude reparameterization at the banked draws: round trip to
    1e-10, ``log_prob_v(T(u))`` against ``log_prob(u)`` to 1e-12 relative
    (the same point up to the round trip's roundoff), card vs CPU to 1e-10."""
    from gpcsd_tpu_torch.models.reparam import AmplitudeReparam

    gfns, gY = gpu._fns(), gpu._Y()
    rp, rp_cpu = AmplitudeReparam(gfns), AmplitudeReparam(cpu._fns())
    u = torch.tensor(draws, device=gpu.device)
    qf.launch_count = 0
    with torch.no_grad():
        v = rp.forward(u)
        round_trip = float((rp.inverse(v) - u).abs().max())
        lp_v = rp.wrap_log_prob(gfns.log_prob)(v, gY)
        lp_u = gfns.log_prob(u, gY)
        v_cpu = rp_cpu.forward(torch.tensor(draws))
    launches = qf.launch_count
    lp_rel = float(((lp_v - lp_u).abs() / lp_u.abs()).max())
    vs_cpu = float((v.cpu() - v_cpu).abs().max())
    emit("reparam", draws=len(draws), launches=launches, round_trip_max_abs=round_trip,
         log_prob_rel_err=lp_rel, forward_vs_cpu_max_abs=vs_cpu,
         moved_max_abs=float((v - u).abs().max()))
    check(round_trip <= 1e-10, f"reparam: inverse(forward(u)) off by {round_trip}")
    check(lp_rel <= 1e-12, f"reparam: log_prob_v(T(u)) vs log_prob(u) rel {lp_rel}")
    check(vs_cpu <= 1e-10, f"reparam: forward card vs CPU {vs_cpu}")
    check(launches == 2 * len(draws), f"reparam: {launches} launches for {2 * len(draws)} rows")
    return launches


def phase_advi(qf, gpu, cpu, u_center):
    """A few ADVI steps from the banked centre; the first ELBO against the
    CPU on the same draws to 1e-9 relative."""
    from gpcsd_tpu_torch.infer.advi import advi_fit, draw_eps, elbo

    gfns, gY = gpu._fns(), gpu._Y()
    cfns, cY = cpu._fns(), cpu._Y()
    eps = draw_eps(torch.Generator().manual_seed(0), ADVI_STEPS, ADVI_N_MC, u_center.size)
    qf.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = advi_fit(lambda u: gfns.log_prob(u, gY), torch.tensor(u_center, device=gpu.device),
                   num_steps=ADVI_STEPS, n_mc=ADVI_N_MC, eps=eps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = qf.launch_count
    trace = res.elbo_trace.cpu().numpy()
    mu0 = torch.tensor(u_center)
    with torch.no_grad():
        first_cpu = float(elbo(lambda u: cfns.log_prob(u, cY), mu0, torch.full_like(mu0, -2.0), eps[0]))
    emit("advi", steps=ADVI_STEPS, n_mc=ADVI_N_MC, launches=launches, seconds=seconds,
         ms_per_step=1e3 * seconds / ADVI_STEPS, elbo_first=float(trace[0]),
         elbo_last=float(trace[-1]), elbo_first_cpu=first_cpu,
         elbo_first_rel_err_vs_cpu=rel(float(trace[0]), first_cpu),
         mu_moved_max_abs=float((res.mu.cpu() - mu0).abs().max()))
    check(np.all(np.isfinite(trace)), f"advi: a step's ELBO is not finite: {trace}")
    check(bool(torch.isfinite(res.mu).all() and torch.isfinite(res.rho).all()), "advi: mu or rho")
    check(launches == ADVI_STEPS * ADVI_N_MC,
          f"advi: {launches} launches for {ADVI_STEPS} steps x {ADVI_N_MC} draws")
    check(rel(float(trace[0]), first_cpu) <= 1e-9, "advi: first ELBO card vs CPU above 1e-9")
    return launches


def phase_smc(qf, gpu, cpu):
    """Tempered SMC from prior particles on the model's own prior and
    likelihood; the first stage's temperature step and evidence increment
    against the CPU on the same numbers: 1e-6 relative for the step, 1e-5 for
    the increment.  At prior draws the two eigensolvers agree less well than
    at posterior draws (phase ``log_prob``: 1e-9): the increment's reading on
    an H100 is 9.8e-7, a ~1.4e-7 relative difference in the largest
    log-likelihoods (~1.4e6) times the temperature step."""
    from gpcsd_tpu_torch.infer.smc import smc_run
    from gpcsd_tpu_torch.models.inference_api import prior_starts

    def evaluators(model):
        fns, Y = model._fns(), model._Y()
        return fns.log_prior_u, lambda u: fns.loglik(fns.param_set.unpack(u), Y)

    p0 = prior_starts(gpu._fns(), 0, SMC_PARTICLES)
    kw = dict(n_mutation_steps=SMC_MUTATIONS, chunk=16)
    qf.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = smc_run(*evaluators(gpu), torch.tensor(p0, device=gpu.device),
                  torch.Generator().manual_seed(0), max_stages=SMC_MAX_STAGES, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = qf.launch_count
    want = SMC_PARTICLES * (1 + res.n_stages * SMC_MUTATIONS)
    one = smc_run(*evaluators(cpu), torch.tensor(p0), torch.Generator().manual_seed(0),
                  max_stages=1, **kw)
    lams = res.temperatures.cpu().numpy()
    incs = res.log_evidence_increments.cpu().numpy()
    errs = {"temperature": rel(float(lams[0]), float(one.temperatures[0])),
            "evidence_increment": rel(float(incs[0]), float(one.log_evidence_increments[0]))}
    emit("smc", particles=SMC_PARTICLES, mutation_steps=SMC_MUTATIONS, stages=res.n_stages,
         launches=launches, seconds=seconds, ms_per_particle_evaluation=1e3 * seconds / launches,
         temperatures=lams.tolist(), log_evidence=float(res.log_evidence),
         log_evidence_increments=incs.tolist(), acceptance=float(res.acceptance),
         host_reads_per_stage=res.n_host_reads / res.n_stages, first_stage_rel_err_vs_cpu=errs)
    check(res.n_stages >= 1 and np.all(np.diff(np.concatenate([[0.0], lams])) > 0),
          f"smc: temperatures do not rise: {lams}")
    check(np.isfinite(float(res.log_evidence)), "smc: log-evidence is not finite")
    check(bool(torch.isfinite(res.particles).all()), "smc: a particle is not finite")
    check(launches == want, f"smc: {launches} launches for {want} particle evaluations")
    check(res.n_host_reads == res.n_stages, "smc: more than one host read per stage")
    check(errs["temperature"] <= 1e-6 and errs["evidence_increment"] <= 1e-5,
          f"smc: first stage card vs CPU {errs}")
    return launches


def phase_ic(qf, gpu, post):
    """WAIC and PSIS-LOO over the nuts phase's posterior, and the pointwise
    terms summed over trials against ``loglik`` through the kernel (plus
    the 2 pi constant) to 1e-9 relative."""
    from gpcsd_tpu_torch.infer import model_comparison as mc

    gfns, gY = gpu._fns(), gpu._Y()
    ntrials, nx, nt = gY.shape
    gpu.posterior = post
    qf.launch_count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gpu.information_criteria(max_draws=32)
    seconds = time.perf_counter() - t0
    us = post.raw.samples[:, -2:].reshape(-1, post.raw.samples.shape[-1])  # 8 draws
    ll = mc.pointwise_loglik(gfns, us, gY)
    with torch.no_grad():
        want = gfns.loglik(gfns.param_set.unpack(us), gY).cpu().numpy()
    launches = qf.launch_count
    want = want - 0.5 * ntrials * nx * nt * np.log(2.0 * np.pi)
    sum_err = float(np.max(np.abs(ll.sum(axis=1) - want) / np.abs(want)))
    emit("ic", draws=out["n_draws"], seconds=seconds, seconds_per_draw=seconds / out["n_draws"],
         launches=launches, trials=ntrials, sum_over_trials_rel_err_vs_kernel=sum_err,
         waic={k: v for k, v in out["waic"].items() if k != "pointwise_elpd"},
         loo={k: v for k, v in out["loo"].items() if k not in ("pointwise_elpd", "pareto_k")},
         max_pareto_k=float(np.max(out["loo"]["pareto_k"])))
    check(out["n_draws"] == 32 and ll.shape == (len(us), ntrials), "ic: shapes")
    for name, key in (("waic", "elpd_waic"), ("waic", "p_waic"), ("loo", "elpd_loo"), ("loo", "p_loo")):
        check(np.isfinite(out[name][key]), f"ic: {key} is not finite")
    check(out["loo"]["pointwise_elpd"].shape == (ntrials,), "ic: pointwise elpd")
    check(sum_err <= 1e-9, f"ic: pointwise sum vs loglik through the kernel, rel {sum_err}")
    check(launches == len(us), f"ic: {launches} launches for {len(us)} loglik rows")
    return launches


def phase_paper_run(qf, smi):
    """The paper run at short lengths: stopped, resumed, and
    uninterrupted on the same cached inputs."""
    from gpcsd_tpu_torch import config, paper_run

    lengths = ["--restarts", "2", "--map-maxiter", "5", "--polish-maxiter", "5",
               "--warmup", "6", "--samples", "4"]
    tmp = tempfile.mkdtemp(prefix="paper_run_")
    try:
        a, b, c = (os.path.join(tmp, d) for d in "abc")
        qf.launch_count = 0
        t0 = time.perf_counter()
        # the first stop falls inside the MAP stage, the second in the sampler
        rc_map_stop = paper_run.main(["--out-dir", a, "--max-seconds", "0", *lengths])
        map_stop_files = sorted(os.listdir(a))
        rc_stop = paper_run.main(["--out-dir", a, "--max-seconds", "0", *lengths])
        stopped_at = len(json.load(open(os.path.join(a, "chunk_timing.json"))))
        check(not os.path.exists(os.path.join(a, "paper_nuts_auditory.json")),
              "paper_run: the stopped run wrote an artifact")
        rc_resume = paper_run.main(["--out-dir", a, *lengths])
        os.makedirs(b)
        for name in ("surrogate_lfp.npz", "map_params.pkl", "mode_params.pkl", "hessian_f64.npz"):
            shutil.copy2(os.path.join(a, name), os.path.join(b, name))
        rc_whole = paper_run.main(["--out-dir", b, *lengths])
        # one uninterrupted MAP stage on the same surrogate
        os.makedirs(c)
        shutil.copy2(os.path.join(a, "surrogate_lfp.npz"), os.path.join(c, "surrogate_lfp.npz"))
        paper_run.fit_map(paper_run.build_model(c, 1200, 100, 0, config.DEFAULT_DEVICE), c,
                          restarts=2, maxiter=5, seed=0)
        seconds = time.perf_counter() - t0
        launches = qf.launch_count
        maps = [pickle.load(open(os.path.join(d, "map_params.pkl"), "rb")) for d in (a, c)]
        map_same = maps[0].keys() == maps[1].keys() and all(
            np.array_equal(np.asarray(maps[0][k]), np.asarray(maps[1][k])) for k in maps[1])
        art = json.load(open(os.path.join(a, "paper_nuts_auditory.json")))
        with np.load(os.path.join(a, "posterior_samples.npz")) as da, \
                np.load(os.path.join(b, "posterior_samples.npz")) as db:
            same = all(np.array_equal(da[k], db[k]) for k in da.files) and set(da.files) == set(db.files)
            draws_shape = list(da["raw_u"].shape)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    leapfrogs = art["mean_leapfrogs_per_sample"] * art["config"]["chains"] * art["config"]["samples"]
    emit("paper_run", seconds=seconds, exit_codes=[rc_map_stop, rc_stop, rc_resume, rc_whole],
         map_stop_files=map_stop_files, map_resumed_equals_uninterrupted=bool(map_same),
         stopped_after_transitions=stopped_at, launches=launches, draws_shape=draws_shape,
         resumed_equals_uninterrupted=bool(same), healthy=art["healthy"], max_rhat=art["max_rhat"],
         divergences=art["divergences"], step_size=art["step_size"],
         max_abs_z_vs_banked=max(abs(v["z"]) for v in art["vs_banked"].values()))
    check([rc_map_stop, rc_stop, rc_resume, rc_whole] == [3, 3, 0, 0], "paper_run: exit codes")
    check("map_state.npz" in map_stop_files and "map_params.pkl" not in map_stop_files,
          f"paper_run: the MAP stage's stop left {map_stop_files}")
    check(map_same, "paper_run: the stopped and resumed MAP differs from the uninterrupted one")
    check(stopped_at == 5, f"paper_run: stopped after {stopped_at} transitions, not at the first save")
    check(same, "paper_run: the resumed run's draws differ from the uninterrupted run's")
    check(set(art) == ARTIFACT_KEYS, f"paper_run: artifact keys {sorted(set(art) ^ ARTIFACT_KEYS)}")
    check(art["nvidia_smi"] == smi and art["config"]["nt"] == 600 and art["config"]["nx"] == 24,
          "paper_run: the artifact's card or configuration")
    check(draws_shape == [4, 4, 30], f"paper_run: draws have shape {draws_shape}")
    check(launches >= 2 * leapfrogs > 0,
          f"paper_run: {launches} launches for two runs of {leapfrogs} sampling leapfrogs")
    return launches


#: map_resume: restarts x iterations at the paper configuration, and the
#: iterations between checkpoints
MAP_RESUME = dict(n_restarts=3, maxiter=12, chunk_iters=3)


def phase_map_resume(qf, gpu, smi):
    """The resumable MAP at the paper configuration: ``fit`` of
    ``MAP_RESUME`` once uninterrupted, and once stopped by
    ``max_wall_seconds=0`` at every checkpoint and rerun until done; ``u``,
    the NLLs and the evaluations equal bit for bit.  The checkpoint's saves
    are timed where the optimizer calls them (ms a save, the device's state
    copied to the host included) and its files weighed."""
    from gpcsd_tpu_torch.infer import lbfgs
    from gpcsd_tpu_torch.infer.lbfgs import LBFGSTimeBudget

    n, maxiter, chunk = MAP_RESUME["n_restarts"], MAP_RESUME["maxiter"], MAP_RESUME["chunk_iters"]
    save = lbfgs.save_sampler_state
    save_s = []

    def timed_save(state, path):
        t = time.perf_counter()
        save(state, path)
        save_s.append(time.perf_counter() - t)

    tmp = tempfile.mkdtemp(prefix="map_resume_")
    qf.launch_count = 0
    try:
        t0 = time.perf_counter()
        whole = gpu.fit(n_restarts=n, seed=0, options={"maxiter": maxiter})
        whole_s = time.perf_counter() - t0
        opts = {"maxiter": maxiter, "chunk_iters": chunk, "max_wall_seconds": 0,
                "state_path": os.path.join(tmp, "map_state")}
        stops, calls = 0, 0
        lbfgs.save_sampler_state = timed_save
        t0 = time.perf_counter()
        while True:
            calls += 1
            check(calls <= maxiter, "map_resume: the stopped fit makes no progress")
            try:
                res = gpu.fit(n_restarts=n, seed=0, options=opts)
                break
            except LBFGSTimeBudget:
                stops += 1
        resumed_s = time.perf_counter() - t0
        state_bytes = sum(os.path.getsize(opts["state_path"] + ext)
                          for ext in (".npz", ".structure.pkl"))
    finally:
        lbfgs.save_sampler_state = save
        shutil.rmtree(tmp, ignore_errors=True)
    launches = qf.launch_count
    same = (np.array_equal(res.u_all, whole.u_all) and np.array_equal(res.nll_values, whole.nll_values)
            and np.array_equal(res.n_evals, whole.n_evals))
    emit("map_resume", card=smi, restarts=n, maxiter=maxiter, chunk_iters=chunk, stops=stops,
         saves=len(save_s), save_ms=[1e3 * t for t in save_s], state_bytes=state_bytes,
         uninterrupted_seconds=whole_s, stopped_and_resumed_seconds=resumed_s,
         n_iter=[m.split("iters=")[1] for m in whole.messages], evals=whole.n_evals.tolist(),
         nll=whole.nll_values.tolist(), resumed_equals_uninterrupted=bool(same), launches=launches)
    check(same, "map_resume: the stopped and resumed fit differs from the uninterrupted one")
    check(stops >= 1 and len(save_s) >= stops, f"map_resume: {stops} stops, {len(save_s)} saves")
    check(launches == 2 * int(whole.n_evals.sum()),
          f"map_resume: {launches} launches for 2 x {int(whole.n_evals.sum())} evaluations")
    return launches


def phase_noise_probe(qf, gpu, cpu, lfp, time_ms, u_center, smi):
    """The likelihood noise probe (``gpcsd_tpu_torch.noise_probe.probe``)
    at the banked posterior's centre, ``het_noise`` "exact" and "approx",
    on the card and on the CPU: 33 values of log p along a segment of
    half-width 1e-2, the RMS residual of a quadratic fit."""
    from gpcsd_tpu_torch import noise_probe, paper

    models = {"exact": (gpu, cpu),
              "approx": (paper.build_model(lfp, time_ms, het_noise="approx", device=gpu.device),
                         paper.build_model(lfp, time_ms, het_noise="approx", device="cpu"))}
    qf.launch_count = 0
    out = {}
    for het, (card_model, cpu_model) in models.items():
        t0 = time.perf_counter()
        card = noise_probe.probe(card_model, u_center)
        card_s = time.perf_counter() - t0
        host = noise_probe.probe(cpu_model, u_center)
        out[het] = {"rms_card": card["rms"], "rms_cpu": host["rms"],
                    "max_abs_residual_card": card["max_abs_residual"],
                    "max_abs_residual_cpu": host["max_abs_residual"],
                    "logp_center_card": card["center"], "logp_center_cpu": host["center"],
                    "range_card": card["range"], "card_seconds": card_s}
    launches = qf.launch_count
    emit("noise_probe", card=smi, scale=1e-2, npts=33, launches=launches, **out)
    for het, r in out.items():
        check(r["rms_card"] < 1e-2, f"noise_probe: {het} RMS {r['rms_card']} on the card")
        check(r["rms_card"] <= 10 * r["rms_cpu"],
              f"noise_probe: {het} RMS {r['rms_card']} on the card, {r['rms_cpu']} on the CPU")
    check(launches == 2 * 33, f"noise_probe: {launches} launches for 66 evaluations")
    return launches


def phase_profiling(qf, dev, smi, bench_evals_per_s):
    """``gpcsd_tpu_torch.utils.profiling`` at the bench point: a ``trace`` of
    3 value+grad evaluations (the Chrome trace must name the quadform
    kernel), and ``measure_evals_per_second`` and ``Throughput`` over the
    bench's 50 points, beside the ``bench`` phase's median.  Those two
    differ in definition: ``infer.map.value_and_grad`` reads each value to
    the host, ``bench_evals_per_s`` keeps it on the card."""
    from gpcsd_tpu_torch.bench import bench_points, build_problem
    from gpcsd_tpu_torch.infer.map import value_and_grad
    from gpcsd_tpu_torch.utils.profiling import Throughput, measure_evals_per_second, trace

    bench = build_problem(device=dev)
    bfns, bY = bench._fns(), bench._Y()
    us = bench_points(bench, 50)

    def step(u):
        return value_and_grad(lambda ut: bfns.neg_log_joint(ut, bY), u, dev)

    qf.launch_count = 0
    rate = measure_evals_per_second(step, [(u,) for u in us], warmup=3)
    with Throughput("value+grad") as tp:
        for u in us:
            step(u)
            tp.add()
    tmp = tempfile.mkdtemp(prefix="trace_")
    try:
        with trace(tmp) as prof:
            for u in us[:3]:
                step(u)
        trace_bytes = os.path.getsize(prof.trace_path)
        with open(prof.trace_path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = sorted(n for n in names if "quadform" in n)
    launches = qf.launch_count
    emit("profiling", card=smi, measure_evals_per_s=rate, throughput_evals_per_s=tp.rate,
         bench_phase_evals_per_s=bench_evals_per_s, trace_bytes=trace_bytes,
         trace_quadform_names=[k[:80] for k in kernels], launches=launches)
    check(any("quadform_gemm_kernel" in k for k in kernels),
          f"profiling: the trace names no quadform kernel launch ({kernels})")
    check(rate > 0 and tp.count == len(us), "profiling: the counters counted nothing")
    check(launches == 3 + 2 * len(us) + 3, f"profiling: {launches} launches")
    return launches


def phase_timing(qf, dev, smi):
    """The covariances' and the log-likelihood value's milliseconds at the
    bench point, and the quadform kernel against its plain version at the
    main-path shape.  Returns the kernel's and the plain version's device
    milliseconds."""
    from gpcsd_tpu_torch.bench import build_problem

    bench = build_problem(device=dev)
    bfns, bY = bench._fns(), bench._Y()
    u0 = bfns.param_set.pack(bench._theta()).cpu().numpy()
    with torch.no_grad():
        theta = bfns.param_set.unpack(torch.as_tensor(u0, device=dev))
        factor_ms = cuda_ms(lambda: bfns.build_factors(theta), 20)
        value_ms = cuda_ms(lambda: bfns.loglik(theta, bY), 20)

    kt = kernel_times(qf, SHAPE_1D, dev)
    emit("timing", card=smi, covariances_and_eighs_ms=factor_ms, loglik_value_ms=value_ms, **kt)
    return kt["quadform_device_ms"], kt["quadform_plain_device_ms"]


def kernel_times(qf, shape, dev, rows=False):
    """The quadform kernel (``rows``: the per-trial one) against its plain
    version at ``shape``: device milliseconds (CUDA graph of 50 calls) and
    eager milliseconds, each in turns plain-kernel-kernel-plain so that
    drift between them cancels."""
    ins = kernel_inputs(torch.Generator().manual_seed(1), *shape, dev)
    cuda_fn, plain_fn = ((qf.quadform_rows_cuda, qf.quadform_rows_reference) if rows
                         else (qf.quadform_cuda, qf.quadform_reference))
    kernel = lambda: cuda_fn(*ins)  # noqa: E731
    plain = lambda: plain_fn(*ins)  # noqa: E731
    dev_runs = [graph_ms(f) for f in (plain, kernel, kernel, plain)]
    eager_runs = [cuda_ms(f, 50) for f in (plain, kernel, kernel, plain)]
    return dict(
        quadform_device_ms=np.mean(dev_runs[1:3]), quadform_plain_device_ms=np.mean(dev_runs[::3]),
        quadform_ms=np.mean(eager_runs[1:3]), quadform_plain_ms=np.mean(eager_runs[::3]),
        quadform_device_ms_runs=dev_runs[1:3], quadform_plain_device_ms_runs=dev_runs[::3],
        quadform_ms_runs=eager_runs[1:3], quadform_plain_ms_runs=eager_runs[::3],
        shape=list(shape))


# ------------------------------------------------------------- the 2D path

#: card vs CPU at the Neuropixels shape, and batched vs unbatched on the card
#: (cuSOLVER solves a batch by another algorithm).  The 69 x 69 quadrature
#: Gram has norm 4e10 (quadrature weights in um^2) and ~40 eigenvalues below
#: its roundoff 1e-16 * 4e10 = 4e-6; what an eigensolver returns for them,
#: times Kt's eigenvalues (up to ~150), is up to 6e-4 beside the noise
#: variance 0.1.  So two float64 eigensolvers disagree by ~1e-5 in the
#: log-likelihood of this white-noise LFP and by ~1e-2 in its predictions,
#: whose energy lies in those directions; the variances do not feel it.  H100
#: readings: value 1.4e-5, gradient 1.6e-4 (temporal part 1.9e-4), batched
#: value 7.5e-6 and gradient 1.1e-4, predict 8.8e-3, variance 1.3e-8,
#: samples 4.2e-3.  Each limit leaves a factor of 5-8.
TOL_2D = {"value": 1e-4, "grad": 1e-3, "grad_temporal": 1e-3, "batched_value": 5e-5,
          "batched_grad": 1e-3, "predict": 5e-2, "variance": 1e-7, "samples": 3e-2}


def u_points_2d(model, n, scale=0.01, seed=1):
    """The model's point in u-space and ``n - 1`` jittered copies, (n, dim)."""
    u0 = model._fns().param_set.pack(model._theta()).cpu().numpy()
    us = u0[None, :] + scale * np.random.default_rng(seed).normal(size=(n, u0.size))
    us[0] = u0
    return us


def phase_log_prob_2d(qf, gpu, cpu):
    """loglik and log_prob value and gradient, card vs CPU, and the batched
    call vs the unbatched one on the card (limits: :data:`TOL_2D`)."""
    from gpcsd_tpu_torch.infer.map import value_and_grad
    from gpcsd_tpu_torch.models.core import value_and_grad_rows

    gfns, gY = gpu._fns(), gpu._Y()
    cfns, cY = cpu._fns(), cpu._Y()
    qf.launch_count = 0
    ll_gpu, ll_cpu = gpu.loglik(), cpu.loglik()
    us = u_points_2d(gpu, 5)
    worst = {"loglik": rel(ll_gpu, ll_cpu), "value": 0.0, "grad": 0.0, "grad_temporal": 0.0,
             "batched_value": 0.0, "batched_grad": 0.0}
    bv, bg = value_and_grad_rows(lambda u: gfns.log_prob(u, gY), torch.tensor(us, device=gpu.device))
    bv, bg = bv.cpu().numpy(), bg.cpu().numpy()
    single = []
    t0 = time.perf_counter()
    for i, u in enumerate(us):
        v, g = value_and_grad(lambda ut: gfns.log_prob(ut, gY), u, gpu.device)
        check(np.isfinite(v) and np.all(np.isfinite(g)), "log_prob_2d: non-finite on the card")
        worst["batched_value"] = max(worst["batched_value"], rel(bv[i], v))
        worst["batched_grad"] = max(worst["batched_grad"], rel_norm(bg[i], g))
        single.append((v, g))
    gpu_seconds = time.perf_counter() - t0
    launches = qf.launch_count
    t0 = time.perf_counter()
    for (v, g), u in zip(single, us):
        vc, gc = value_and_grad(lambda ut: cfns.log_prob(ut, cY), u, "cpu")
        worst["value"] = max(worst["value"], rel(v, vc))
        worst["grad"] = max(worst["grad"], rel_norm(g, gc))
        worst["grad_temporal"] = max(worst["grad_temporal"], rel_norm(g[3:7], gc[3:7]))
    emit("log_prob_2d", loglik=ll_gpu, loglik_cpu=ll_cpu, points=len(us), launches=launches,
         seconds_per_eval_card=gpu_seconds / len(us),
         seconds_per_eval_cpu=(time.perf_counter() - t0) / len(us), rel_err=worst)
    check(launches == 1 + 2 * len(us), f"log_prob_2d: {launches} launches for {1 + 2 * len(us)} rows")
    check(worst["loglik"] <= TOL_2D["value"], "log_prob_2d: loglik card vs CPU")
    for key in ("value", "grad", "grad_temporal", "batched_value", "batched_grad"):
        check(worst[key] <= TOL_2D[key], f"log_prob_2d: {key} {worst[key]} above {TOL_2D[key]}")
    return launches


def phase_fit_2d(qf, paper, dev):
    """Batched L-BFGS over 4 restarts for 8 iterations on the card, and one
    scipy restart for its seconds per evaluation."""
    from gpcsd_tpu_torch.infer.map import sample_restarts

    model = paper.neuropixels_problem(0, device=dev)
    fns, Y = model._fns(), model._Y()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    qf.launch_count = 0
    t0 = time.perf_counter()
    res = model.fit(n_restarts=4, backend="torch", seed=0, options={"maxiter": 8})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = qf.launch_count
    peak = torch.cuda.max_memory_allocated()
    u0s = torch.tensor(sample_restarts(fns.param_set, np.random.default_rng(0), 4), device=dev)
    with torch.no_grad():
        nll0 = fns.neg_log_joint(u0s, Y).cpu().numpy()

    serial = paper.neuropixels_problem(0, device=dev)
    before = qf.launch_count
    t0 = time.perf_counter()
    sres = serial.fit(n_restarts=1, backend="scipy", seed=0, options={"maxiter": 8})
    scipy_seconds = time.perf_counter() - t0
    scipy_evals = qf.launch_count - before
    emit("fit_2d", seconds=seconds, restarts=4, maxiter=8, launches=launches,
         evaluations=res.n_evals.tolist(), host_reads=res.n_syncs,
         seconds_per_evaluation=seconds / launches, nll_start=nll0.tolist(),
         nll_end=res.nll_values.tolist(), nll_best=res.nll_best, messages=res.messages,
         peak_memory_bytes=peak, memory_before_bytes=base,
         scipy={"seconds": scipy_seconds, "evaluations": scipy_evals,
                "seconds_per_evaluation": scipy_seconds / scipy_evals,
                "nll_end": sres.nll_values.tolist(), "messages": sres.messages})
    check(launches == int(res.n_evals.sum()) and launches > 0,
          f"fit_2d: {launches} quadform launches for {int(res.n_evals.sum())} evaluations")
    check(np.all(np.isfinite(res.nll_values)), "fit_2d: a restart's NLL is not finite")
    check(np.all(res.nll_values <= nll0), "fit_2d: a restart ended above its start")
    check(np.isfinite(sres.nll_best) and sres.nll_best <= nll0[0], "fit_2d: scipy restart")
    return launches


def phase_predict_2d(gpu, cpu):
    """The 2D outputs at 4 depths down the probe's mid-line, card vs CPU
    (limits: :data:`TOL_2D`), and the variance inside [0, prior]."""
    from gpcsd_tpu_torch.ops.spatial import kphi_2d, pairwise_w

    x, t = gpu.x, gpu.t
    depths = np.linspace(x[:, 1].min() + 50, x[:, 1].max() - 50, 4)
    z = np.stack([np.full(4, x[:, 0].mean()), depths], axis=1)
    nt, ntrials = t.shape[0], gpu.lfp.shape[2]
    errs, secs = {}, {}

    t0 = time.perf_counter()
    gpu.predict(z, t, type="both")
    torch.cuda.synchronize()
    secs["predict"] = time.perf_counter() - t0
    cpu.predict(z, t, type="both")
    for name in ("csd_pred", "lfp_pred"):
        got, want = getattr(gpu, name), getattr(cpu, name)
        check(got.shape == (4, nt, ntrials) and np.all(np.isfinite(got)), f"predict_2d: {name}")
        errs[name] = max_rel(got, want)
        for i, (a, b) in enumerate(zip(getattr(gpu, name + "_list"), getattr(cpu, name + "_list"))):
            errs[f"{name}_list{i}"] = float(np.max(np.abs(a - b)) / np.max(np.abs(want)))
    check(max(errs.values()) <= TOL_2D["predict"], f"predict_2d: card vs CPU {errs}")

    sigma2 = sum(tc.params["sigma2"]["value"] for tc in gpu.temporal_cov_list)
    with torch.no_grad():
        _, gl_xy, gl_w = gpu.spatial_cov.geometry(gpu.device)
        th = gpu._theta()
        kzz = kphi_2d(pairwise_w(gpu._tensor(z), gl_xy), gl_xy, gl_w, th["ell1"], th["ell2"],
                      th["R"], gpu.eps)
        prior = {"csd": np.full(4, sigma2), "lfp": sigma2 * torch.diagonal(kzz).cpu().numpy()}
    var_min_over_prior = {}
    for kind in ("csd", "lfp"):
        t0 = time.perf_counter()
        var = gpu.predict_variance(z, t, type=kind)
        secs[f"variance_{kind}"] = time.perf_counter() - t0
        want = cpu.predict_variance(z, t, type=kind)
        check(var.shape == (4, nt) and np.all(np.isfinite(var)), f"predict_2d: variance {kind}")
        errs[f"variance_{kind}"] = float(np.max(np.abs(var - want)) / prior[kind].max())
        var_min_over_prior[kind] = float(np.min(var / prior[kind][:, None]))
        check(np.all(var >= -1e-9 * prior[kind][:, None]), f"predict_2d: {kind} variance below 0")
        check(np.all(var <= prior[kind][:, None]), f"predict_2d: {kind} variance above the prior")
        check(errs[f"variance_{kind}"] <= TOL_2D["variance"], f"predict_2d: variance {kind} {errs}")

    t0 = time.perf_counter()
    samples = gpu.predict_samples(z, t, n_draws=8, seed=0)  # 3604 union points: RFF
    secs["samples"] = time.perf_counter() - t0
    want = cpu.predict_samples(z, t, n_draws=8, seed=0)
    check(samples.shape == (8, 4, nt) and np.all(np.isfinite(samples)), "predict_2d: samples")
    errs["samples"] = max_rel(samples, want)
    check(errs["samples"] <= TOL_2D["samples"], f"predict_2d: samples card vs CPU {errs}")

    t0 = time.perf_counter()
    csd, lfp = gpu.sample_prior(2, type="both")
    secs["sample_prior"] = time.perf_counter() - t0
    check(csd.shape == lfp.shape == (x.shape[0], nt, 2), "predict_2d: sample_prior shapes")
    check(np.all(np.isfinite(csd)) and np.all(np.isfinite(lfp)), "predict_2d: sample_prior")
    emit("predict_2d", seconds=secs, sites=z.tolist(), rel_err_vs_cpu=errs,
         variance_min_over_prior=var_min_over_prior,
         csd_sd_posterior_over_prior=float(np.sqrt(np.mean(
             gpu.predict_variance(z, t, type="csd")) / sigma2)),
         sample_sd=float(samples.std()))


def phase_timing_2d(qf, gpu, smi):
    """Value+grad evals/s in 2D with distinct inputs per evaluation, and the
    quadform kernel against its plain version and its bound at the shape the
    2D path gives it."""
    from gpcsd_tpu_torch.infer.map import value_and_grad

    fns, Y, dev = gpu._fns(), gpu._Y(), gpu.device
    us = u_points_2d(gpu, 33)
    for u in us[:3]:
        value_and_grad(lambda ut: fns.neg_log_joint(ut, Y), u, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for u in us[3:]:
        value_and_grad(lambda ut: fns.neg_log_joint(ut, Y), u, dev)
    torch.cuda.synchronize()
    evals_per_s = (len(us) - 3) / (time.perf_counter() - t0)
    with torch.no_grad():
        theta = fns.param_set.unpack(torch.as_tensor(us[0], device=dev))
        ks_ms = cuda_ms(lambda: fns.build_ks(theta), 20)
        factor_ms = cuda_ms(lambda: fns.build_factors(theta), 20)
        value_ms = cuda_ms(lambda: fns.loglik(theta, Y), 20)
    kt = kernel_times(qf, SHAPE_2D, dev)
    bound_ms, bound_by = quadform_bound_ms(*SHAPE_2D)
    return dict(card=smi, log_joint_value_grad_evals_per_s=evals_per_s, spatial_gram_ms=ks_ms,
                covariances_and_eighs_ms=factor_ms, loglik_value_ms=value_ms,
                quadform_bound_ms=bound_ms, quadform_bound_by=bound_by, **kt)


def profile_2d(gpu, evals=20):
    """Device time per value+grad evaluation in 2D and its largest kernels,
    from ``torch.profiler`` over ``evals`` evaluations at distinct points."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gpcsd_tpu_torch.infer.map import value_and_grad

    fns, Y, dev = gpu._fns(), gpu._Y(), gpu.device
    us = u_points_2d(gpu, evals + 2, seed=2)
    for u in us[:2]:
        value_and_grad(lambda ut: fns.neg_log_joint(ut, Y), u, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for u in us[2:]:
            value_and_grad(lambda ut: fns.neg_log_joint(ut, Y), u, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) * 1e-3
    check(busy > 0, "the profiler recorded no device time")
    top = sorted(((e.key, getattr(e, "self_device_time_total", 0.0), e.count)
                  for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                 key=lambda kv: -kv[1])[:12]
    return {"profile_evals": evals, "device_ms_per_eval": busy / evals,
            "profiled_wall_ms_per_eval": 1e3 * wall / evals,
            "top_kernels_us_per_eval": [[k[:60], v / evals, c / evals] for k, v, c in top]}


# ------------------------------------------------ the paper's analysis stages

#: parameters the signal phase restores into the auditory twin's models in
#: place of a fit (the surrogate generator's values, noise 0.01)
SIGNAL_PARAMS = {"R": 150.0, "sig2n": np.full(24, 0.01), "spatial_ell": 300.0,
                 "temporal_ell_list": [40.0, 5.0], "temporal_sigma2_list": [1.0, 0.5]}
#: auditory torus graph (d = 48 from n = 60 trials, 2256 parameters held up
#: by the ridge alone), card vs CPU, relative to the largest magnitude.
#: H100 readings: phi 3.3e-14, partial PLV 2.8e-13; each limit 6-7x that
TOL_TORUS_AUDITORY = {"phi": 2e-13, "cond_coupling": 2e-12}
#: workloads phase: the JAX workloads' defaults cut to keep the phase short
AUD_RESTARTS, FMF_RESTARTS = 3, 3


def sync_seconds(fn):
    """(result, wall seconds) of ``fn()`` with the device synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def auditory_predictions(dev, tmp):
    """The auditory twin's two surrogate probes at full width (24 channels,
    400 samples, 60 trials), each model restored from a pickle of
    :data:`SIGNAL_PARAMS` by the twin's ``fit_probe``, and its CSD and LFP
    predictions on the trial window as (trials, channels, samples) tensors."""
    import pickle

    from gpcsd_tpu_torch.workloads import auditory_lfp as aud

    out = {}
    for name, (lfp, time_ms) in aud.surrogate(0, 400, 60, device=dev).items():
        cache = os.path.join(tmp, f"gpcsd_model_{name}.pkl")
        with open(cache, "wb") as f:
            pickle.dump(SIGNAL_PARAMS, f)
        base = time_ms < 0
        model = aud.fit_probe(lfp[:, base, :], time_ms[base], cache=cache, device=dev)
        trial = (time_ms >= 0) & (time_ms < min(500.0, time_ms.max()))
        model.update_lfp(lfp[:, trial, :], time_ms[trial].reshape(-1, 1))
        pred = model.predict_tensors(np.linspace(aud.A, aud.B, aud.NX), time_ms[trial], type="both")
        out[name] = (pred["csd"][0], pred["lfp"][0])
    return out


def phase_signal(dev, smi):
    """The signal functions at the auditory window on the CSD and LFP
    predictions: card vs scipy (1e-10 of the largest magnitude), card vs the
    port on the CPU (1e-12), phases as |exp(i phi) - exp(i phi')| <= 1e-9.
    Returns the CSD phases at the window's midpoint, (48, 60), lateral then
    medial."""
    import scipy.signal as ss

    from gpcsd_tpu_torch import signal as tsig

    tmp = tempfile.mkdtemp(prefix="signal_")
    try:
        preds = auditory_predictions(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sos = tsig.butter_bandpass_sos(8.0, 12.0, 1000.0, order=4)
    errs = {"scipy": 0.0, "cpu": 0.0, "phase_scipy": 0.0, "phase_cpu": 0.0}
    ms = {}
    phases = []
    for name, (csd, lfp) in preds.items():
        for kind, x in (("csd", csd), ("lfp", lfp)):
            xn = x.cpu().numpy()
            filt = tsig.bandpass_filtfilt(x, 8.0, 12.0, 1000.0, device=dev)
            ph = tsig.instantaneous_phase(filt, device=dev)
            f, pxx = tsig.periodogram(x, fs=1000.0, device=dev)
            want_filt = ss.sosfiltfilt(sos, xn, axis=-1)
            want_ph = np.angle(ss.hilbert(want_filt, axis=-1))
            _, want_pxx = ss.periodogram(xn, fs=1000.0, axis=-1)
            cpu_filt = tsig.bandpass_filtfilt(xn, 8.0, 12.0, 1000.0, device="cpu")
            cpu_ph = tsig.instantaneous_phase(cpu_filt, device="cpu").numpy()
            errs["scipy"] = max(errs["scipy"], max_rel(filt.cpu().numpy(), want_filt),
                                max_rel(tsig.hilbert(filt, device=dev).cpu().numpy(),
                                        ss.hilbert(want_filt, axis=-1)),
                                max_rel(pxx.cpu().numpy(), want_pxx))
            errs["cpu"] = max(errs["cpu"], max_rel(filt.cpu().numpy(), cpu_filt.numpy()))
            phn = ph.cpu().numpy()
            errs["phase_scipy"] = max(errs["phase_scipy"],
                                      float(np.abs(np.exp(1j * phn) - np.exp(1j * want_ph)).max()))
            errs["phase_cpu"] = max(errs["phase_cpu"],
                                    float(np.abs(np.exp(1j * phn) - np.exp(1j * cpu_ph)).max()))
            if kind == "csd":
                phases.append(ph[:, :, ph.shape[-1] // 2].T)  # (channels, trials)
        if not ms:
            ms = {"bandpass_filtfilt": cuda_ms(lambda: tsig.bandpass_filtfilt(csd, 8.0, 12.0, 1000.0,
                                                                               device=dev), 20),
                  "instantaneous_phase": cuda_ms(lambda: tsig.instantaneous_phase(filt, device=dev), 20),
                  "plv_matrix": cuda_ms(lambda: tsig.plv_matrix(phases[0], device=dev), 20),
                  "periodogram": cuda_ms(lambda: tsig.periodogram(csd, fs=1000.0, device=dev), 20)}
    plv = tsig.plv_matrix(phases[0], device=dev)
    plv_err = max_rel(plv.cpu().numpy(), tsig.plv_matrix(phases[0].cpu(), device="cpu").numpy())
    emit("signal", card=smi, shape=list(csd.shape), ms=ms, rel_err=errs, plv_rel_err_vs_cpu=plv_err,
         mean_offdiag_plv=float(plv[~torch.eye(24, dtype=torch.bool, device=dev)].mean()))
    check(errs["scipy"] <= 1e-10, f"signal: card vs scipy {errs['scipy']}")
    check(errs["cpu"] <= 1e-12 and plv_err <= 1e-12, f"signal: card vs CPU {errs['cpu']}, plv {plv_err}")
    check(max(errs["phase_scipy"], errs["phase_cpu"]) <= 1e-9, f"signal: phases {errs}")
    check(all(np.isfinite(v) for v in ms.values()), "signal: timings")
    return torch.cat(phases)


def phase_torus(X, dev, smi):
    """A well-posed torus graph (Gibbs sample of a known graph, d = 8,
    n = 4000) card vs CPU to 1e-9; the auditory fit (d = 48, n = 60) card vs
    CPU within :data:`TOL_TORUS_AUDITORY`; the bootstrap of 200 replicates
    at d = 48: ms per replicate, peak device memory, and its first two
    replicates against ``torus_graph_fit`` on their trials (1e-9)."""
    from gpcsd_tpu_torch.models import torus_graph as tg

    lay = tg.layout(8)
    phi_true = np.zeros(lay.m)
    pairs = [tuple(p) for p in lay.pairs.tolist()]
    for e in ((0, 1), (1, 2), (3, 4), (5, 7)):
        phi_true[lay.diff_off + pairs.index(e)] = 1.0
    Xw = tg.gibbs_sample(phi_true, 8, 4000, seed=1)
    fields = ("phi", "pvals", "cond_coupling")
    res_gpu, fit_s = sync_seconds(lambda: tg.torus_graph_fit(Xw, device=dev))
    res_cpu = tg.torus_graph_fit(Xw, device="cpu")
    well = {f: max_rel(getattr(res_gpu, f).cpu().numpy(), getattr(res_cpu, f).numpy()) for f in fields}

    aud_gpu, aud_s = sync_seconds(lambda: tg.torus_graph_fit(X, device=dev))
    aud_cpu = tg.torus_graph_fit(X.cpu(), device="cpu")
    aud = {f: max_rel(getattr(aud_gpu, f).cpu().numpy(), getattr(aud_cpu, f).numpy())
           for f in ("phi", "cond_coupling")}

    nboot, n = 200, X.shape[1]
    idx = torch.randint(0, n, (nboot, n), generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bs, boot_s = sync_seconds(lambda: tg.bootstrap_partial_plv(X, nboot, indices=idx, device=dev))
    peak = torch.cuda.max_memory_allocated()
    first = max(max_rel(bs[:, r].cpu().numpy(),
                        tg.torus_graph_fit(X[:, idx[r].to(dev)], device=dev).cond_coupling.cpu().numpy())
                for r in (0, 1))
    emit("torus", card=smi, well_posed={"d": 8, "n": 4000, "seconds": fit_s, "rel_err_vs_cpu": well},
         auditory={"d": X.shape[0], "n": n, "seconds": aud_s, "rel_err_vs_cpu": aud,
                   "limits": TOL_TORUS_AUDITORY, "max_kappa": float(aud_gpu.kappa.max()),
                   "edges_bonf_001": int(torch.sum(aud_gpu.pvals < 0.001 / 576))},
         bootstrap={"nboot": nboot, "batch_size": tg.BOOT_BATCH, "seconds": boot_s,
                    "ms_per_replicate": 1e3 * boot_s / nboot, "peak_memory_bytes": peak,
                    "memory_before_bytes": base, "first_two_rel_err_vs_fit": first,
                    "ci_width_mean": float((torch.quantile(bs, 0.975, dim=1)
                                            - torch.quantile(bs, 0.025, dim=1)).mean())})
    check(max(well.values()) <= 1e-9, f"torus: well-posed card vs CPU {well}")
    check(all(aud[f] <= TOL_TORUS_AUDITORY[f] for f in aud), f"torus: auditory card vs CPU {aud}")
    check(bool(torch.isfinite(aud_gpu.pvals).all()), "torus: auditory p-values not finite")
    check(tuple(bs.shape) == (tg.layout(X.shape[0]).pairs.shape[0], nboot) and bool(torch.isfinite(bs).all()),
          "torus: bootstrap shape or values")
    check(first <= 1e-9, f"torus: bootstrap replicates vs the fit on their trials {first}")


def phase_shifts(qf, dev, smi):
    """``estimate_shifts`` at fit_mean_function's default shape from one
    model fitted on the card: tau card vs CPU to 1e-6, nll to 1e-9
    relative, every nll finite; the per-trial kernel held against its plain
    version and the scalar kernel at :data:`SHAPE_ROWS_SHIFT` first, then
    its launches = the stage's batched evaluations and no scalar launch.
    Returns the fit's launches, the shift stage's launches of the per-trial
    kernel and that kernel's largest abs error."""
    from gpcsd_tpu_torch.models.gpcsd1d import GPCSD1D
    from gpcsd_tpu_torch.workloads import fit_mean_function as fmf

    x, t, z, lfp, _, _ = fmf.surrogate()
    resid = lfp - lfp.mean(axis=2, keepdims=True)
    gpu = GPCSD1D(resid, x.reshape(-1, 1), t.reshape(-1, 1), device=dev)
    qf.launch_count = 0
    gpu.fit(n_restarts=FMF_RESTARTS, seed=0)
    fit_launches = qf.launch_count
    gpu.update_lfp(lfp.mean(axis=2, keepdims=True), t.reshape(-1, 1))
    gpu.predict(z.reshape(-1, 1), t.reshape(-1, 1))
    evoked_csd = gpu.csd_pred[:, :, 0]
    cpu = GPCSD1D(resid, x.reshape(-1, 1), t.reshape(-1, 1), device="cpu")
    cpu.restore_model_params(gpu.extract_model_params())

    rows_err = check_rows_kernel(qf, SHAPE_ROWS_SHIFT, dev, torch.Generator().manual_seed(2))
    with ShiftStageCount(qf) as sc:
        (labels, n_seg, res, _, _), seconds = sync_seconds(
            lambda: fmf._shift_stage(gpu, lfp, resid, evoked_csd, z, x, t))
    _, _, res_cpu, _, _ = fmf._shift_stage(cpu, lfp, resid, evoked_csd, z, x, t)
    tau_err = float(np.abs(res.tau - res_cpu.tau).max())
    nll_err = float(np.max(np.abs(res.nll - res_cpu.nll) / np.abs(res_cpu.nll)))
    emit("shifts", card=smi, trials=lfp.shape[2], segments=n_seg, seconds=seconds,
         scalar_launches=sc.scalar_launches, **sc.summary(), evaluations=int(res.n_evals.sum()),
         evaluations_per_trial_max=int(res.n_evals.max()), converged_frac=float(res.converged.mean()),
         tau_abs_err_vs_cpu=tau_err, nll_rel_err_vs_cpu=nll_err,
         converged_equal_cpu=bool(np.array_equal(res.converged, res_cpu.converged)))
    check(n_seg >= 1 and res.tau.shape == (lfp.shape[2], n_seg), f"shifts: {n_seg} segments")
    check(np.all(np.isfinite(res.nll)), "shifts: an nll is not finite")
    sc.check("shifts", *SHAPE_ROWS_SHIFT)
    check(sc.scalar_launches == 0, f"shifts: {sc.scalar_launches} scalar launches in the shift stage")
    check(tau_err <= 1e-6 and nll_err <= 1e-9, f"shifts: card vs CPU tau {tau_err}, nll {nll_err}")
    check(fit_launches > 0, "shifts: the fit launched no kernel")
    return fit_launches, sc.launches, rows_err


def phase_workloads(qf, dev, smi):
    """Both twins' ``run()`` on the card at full width: the auditory twin at
    400 samples and 60 trials on two 24-channel probes, fit_mean_function at
    its defaults; restarts cut to :data:`AUD_RESTARTS` and
    :data:`FMF_RESTARTS` (fit_mean_function's own default is 3).  Checks the
    JAX tests' thresholds and that the shift stage's batched evaluations
    each launched the per-trial kernel once.  Returns the scalar kernel's
    launches by shape and the per-trial kernel's launches."""
    from gpcsd_tpu_torch.workloads import auditory_lfp as aud
    from gpcsd_tpu_torch.workloads import fit_mean_function as fmf

    t_aud, t_fmf = {}, {}
    with ShiftStageCount(qf) as sc:
        (m_aud, phases, tg), aud_s = sync_seconds(lambda: aud.run(
            n_restarts=AUD_RESTARTS, nboot=10, seed=0, ntime=400, ntrials=60, device=dev,
            timings=t_aud))
        (m_fmf, res, _), fmf_s = sync_seconds(lambda: fmf.run(
            n_restarts=FMF_RESTARTS, seed=0, device=dev, timings=t_fmf))
    by_shape = sc.scalar_by_shape
    emit("workloads", card=smi,
         auditory_lfp={"seconds": aud_s, "stages": t_aud, "restarts": AUD_RESTARTS,
                       "restarts_cut_from": 10, "nboot": 10, "metrics": m_aud},
         fit_mean_function={"seconds": fmf_s, "stages": t_fmf, "restarts": FMF_RESTARTS,
                            "metrics": m_fmf},
         launches_by_shape={str(list(k)): v for k, v in by_shape.items()}, shift_stage=sc.summary())
    check(phases["lateral"]["csd"].shape == (24, 60), "workloads: auditory phases shape")
    check(bool(torch.isfinite(tg.pvals).all()), "workloads: torus-graph p-values not finite")
    check(0 <= m_aud["tg_edges_bonf_001"] <= 1128, "workloads: auditory edge count")
    check(m_fmf["n_segments"] >= 2, f"workloads: {m_fmf['n_segments']} segments")
    check(m_fmf["best_match_shift_corr_max"] > 0.25, "workloads: shift recovery")
    check(m_fmf["gpcsd_evoked_corr"] > 0.7, "workloads: GPCSD evoked correlation")
    check(np.isfinite(res.tau).all(), "workloads: shifts not finite")
    check(by_shape.get(SHAPE_AUD, 0) > 0 and by_shape.get(SHAPE_FMF, 0) > 0,
          f"workloads: launches by shape {by_shape}")
    sc.check("workloads", *SHAPE_ROWS_SHIFT)
    return by_shape, sc.launches


# -------------------------------------------- the loaders and the other twins

#: io phase: the auditory twin's surrogate written in the reference's text
#: format (2 probes x 24 electrodes, 400 samples, 60 trials)
IO_NTIME, IO_NTRIALS = 400, 60
#: io phase: the twins on the written files, cut to keep the phase short
IO_AUD_RESTARTS, IO_NPX_RESTARTS, IO_NPX_NGL, IO_NPX_NBOOT = 3, 3, (10, 30), 100
#: workloads_2d phase: the Neuropixels twin at its JAX defaults
NPX_RESTARTS, NPX_NBOOT = 20, 1000


def shape_key(shape):
    return str(list(shape))


def run_counted(qf, fn):
    """``fn()`` on a synchronised device with the quadform counts (both
    kernels') set to 0 just before: (result, seconds, launches, launches by
    shape) of the scalar kernel."""
    qf.launch_count = qf.rows_launch_count = 0
    qf.launches_by_shape.clear()
    qf.rows_launches_by_shape.clear()
    out, seconds = sync_seconds(fn)
    return out, seconds, qf.launch_count, dict(qf.launches_by_shape)


def write_auditory_text(dirpath, probes):
    """The probes in the reference's text format: ``time.txt`` in seconds and
    ``<probe>_electrode<i>.txt`` of (samples, trials) values x100."""
    os.makedirs(dirpath, exist_ok=True)
    time_ms = next(iter(probes.values()))[1]
    np.savetxt(os.path.join(dirpath, "time.txt"), time_ms / 1000.0)
    for name, (lfp, _) in probes.items():
        for i in range(lfp.shape[0]):
            np.savetxt(os.path.join(dirpath, f"{name}_electrode{i + 1}.txt"), 100.0 * lfp[i])


def write_neuropixels_pickles(dirpath, npx, dev):
    """The Neuropixels twin's two surrogate probes as pickles in
    ``extract_probe``'s schema (t in seconds, y x100): 150 samples from
    -39.5 to 109.5 ms, so the twin's -40..110 ms window keeps all of them."""
    import pickle

    os.makedirs(dirpath, exist_ok=True)
    x = npx.neuropixels_geometry()
    t_s = (np.arange(NPX_NT) - 39.5) / 1000.0
    for i, probe in enumerate(npx.PROBES):
        lfp, _ = npx.synth_probe(x, nt=NPX_NT, ntrials=40, seed=i, device=dev)
        with open(os.path.join(dirpath, f"neuropixel_viz_{probe}_m405751.pkl"), "wb") as f:
            pickle.dump({"x": x, "t": t_s.reshape(-1, 1), "y": 100.0 * lfp, "fs": 1000,
                         "roi": "V1", "regions": np.ones(x.shape[0], dtype=np.int64)}, f)


def phase_io(qf, dev, smi):
    """The native parser built on this host (else fail); the auditory
    surrogate written as text and loaded cold and from its ``.npy`` cache:
    equal to the written arrays to 1e-12 relative, the native parse equal to
    ``np.loadtxt`` bit for bit; ``auditory_lfp.run(data_dir=)``, then
    ``fit_mean_function.run_real`` restoring the pickles that run wrote, with
    the JAX tests' thresholds; ``neuropixels.run(data_dir=)`` on two pickles
    in ``extract_probe``'s schema at ngl 10 x 30.  ``run_real`` restores its
    models and launches no scalar kernel; its shift stage launches the
    per-trial kernel once per batched evaluation, at (24, 151, B).  Returns
    the scalar kernel's launches by shape of the three runs and the
    per-trial kernel's launches."""
    from gpcsd_tpu_torch import native
    from gpcsd_tpu_torch.io import loaders
    from gpcsd_tpu_torch.workloads import auditory_lfp as aud
    from gpcsd_tpu_torch.workloads import fit_mean_function as fmf
    from gpcsd_tpu_torch.workloads import neuropixels as npx

    check(native.lib() is not None, "io: the native parser did not build on this host")
    tmp = tempfile.mkdtemp(prefix="io_")
    try:
        data = os.path.join(tmp, "aud")
        probes = aud.surrogate(0, IO_NTIME, IO_NTRIALS, device=dev)
        _, write_s = sync_seconds(lambda: write_auditory_text(data, probes))
        (lfp, time_ms), cold_s = sync_seconds(lambda: loaders.load_auditory_probe(data, "lateral"))
        (lfp_hot, _), hot_s = sync_seconds(lambda: loaders.load_auditory_probe(data, "lateral"))
        want = probes["lateral"][0] - probes["lateral"][0].mean(axis=2, keepdims=True)
        load_err = max_rel(lfp, want)
        paths = [os.path.join(data, f"medial_electrode{i + 1}.txt") for i in range(aud.NX)]
        stack = loaders.load_electrode_stack(paths)
        numpy_stack, numpy_s = sync_seconds(lambda: np.stack([np.loadtxt(p) for p in paths]))
        bit_equal = bool(np.array_equal(stack, numpy_stack))

        stage1 = os.path.join(tmp, "stage1")
        t_aud, t_real, t_npx = {}, {}, {}
        (m_aud, phases, tg), aud_s, aud_n, aud_shapes = run_counted(qf, lambda: aud.run(
            data_dir=data, n_restarts=IO_AUD_RESTARTS, nboot=10, seed=0, results_dir=stage1,
            device=dev, timings=t_aud))
        with ShiftStageCount(qf) as sc:
            (m_real, res_real), real_s, real_n, real_shapes = run_counted(qf, lambda: fmf.run_real(
                data, stage1_dir=stage1, seed=0, device=dev, timings=t_real))
        write_neuropixels_pickles(os.path.join(tmp, "npx"), npx, dev)
        m_npx, npx_s, npx_n, npx_shapes = run_counted(qf, lambda: npx.run(
            data_dir=os.path.join(tmp, "npx"), n_restarts=IO_NPX_RESTARTS, ngl1=IO_NPX_NGL[0],
            ngl2=IO_NPX_NGL[1], nboot=IO_NPX_NBOOT, seed=0, device=dev, timings=t_npx))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("io", card=smi, compiler=native.compiler_version(),
         library=os.path.relpath(native.library_path(), ROOT),
         text_files=2 * aud.NX + 1, shape=list(lfp.shape), write_seconds=write_s,
         load_cold_seconds=cold_s, load_cached_seconds=hot_s, numpy_loadtxt_seconds_24_files=numpy_s,
         load_rel_err=load_err, native_equals_loadtxt=bit_equal,
         auditory_lfp={"seconds": aud_s, "stages": t_aud, "restarts": IO_AUD_RESTARTS,
                       "restarts_cut_from": 10, "launches": aud_n,
                       "launches_by_shape": {shape_key(k): v for k, v in aud_shapes.items()},
                       "metrics": m_aud},
         fit_mean_function_real={"seconds": real_s, "stages": t_real, "launches": real_n,
                                 "launches_by_shape": {shape_key(k): v for k, v in real_shapes.items()},
                                 "shift_stage": {"seconds": t_real.get("shifts"), **sc.summary()},
                                 "metrics": m_real},
         neuropixels={"seconds": npx_s, "stages": t_npx, "restarts": IO_NPX_RESTARTS,
                      "restarts_cut_from": 20, "ngl": list(IO_NPX_NGL), "ngl_cut_from": [30, 120],
                      "nboot": IO_NPX_NBOOT, "nboot_cut_from": 1000, "launches": npx_n,
                      "launches_by_shape": {shape_key(k): v for k, v in npx_shapes.items()},
                      "metrics": m_npx})
    check(load_err <= 1e-12, f"io: loaded LFP vs written {load_err}")
    check(np.array_equal(lfp_hot, lfp), "io: the cached load differs from the parse")
    check(bit_equal, "io: the native parse differs from np.loadtxt")
    check(m_aud["source"] == "zenodo" and phases["lateral"]["csd"].shape == (24, IO_NTRIALS),
          "io: auditory real-data run")
    check(bool(torch.isfinite(tg.pvals).all()) and 0 <= m_aud["tg_edges_bonf_001"] <= 1128,
          "io: auditory torus graph")
    for probe in ("lateral", "medial"):
        check(m_real[f"{probe}_stage1_restored"] is True, f"io: {probe} stage-1 pickle not restored")
        check(np.isfinite(m_real[f"{probe}_kcsd_gpcsd_corr"]), f"io: {probe} kCSD correlation")
        check(m_real[f"{probe}_n_segments"] >= 1, f"io: {probe} has no segment")
        check(0.0 <= m_real[f"{probe}_converged_frac"] <= 1.0, f"io: {probe} converged fraction")
    check(m_npx["source"] == "nwb" and m_npx["probeC_csd_pred_shape"][:2] == [4, NPX_NT],
          f"io: neuropixels real-data run {m_npx.get('probeC_csd_pred_shape')}")
    check(aud_shapes.get(SHAPE_AUD, 0) > 0 and real_n == 0 and npx_n > 0,
          f"io: launches {aud_shapes} {real_shapes} {npx_shapes}")
    sc.check("io", *SHAPE_ROWS_REAL)
    return merge_counts(aud_shapes, real_shapes, npx_shapes), sc.launches


def merge_counts(*dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def phase_workloads_sim(qf, dev, smi):
    """``simple_template_1d``, ``sim_from_gp_1d`` (fit and oracle, each with
    the kCSD protocol) and the mismatch study on the card at their JAX
    defaults, with the JAX tests' thresholds.  Returns the launches by
    shape."""
    from gpcsd_tpu_torch.workloads import sim_from_gp_1d as s1
    from gpcsd_tpu_torch.workloads import sim_from_gp_1d_mismatch as mm
    from gpcsd_tpu_torch.workloads import simple_template_1d as st

    runs = {
        "simple_template_1d": lambda t: st.run(device=dev, timings=t)[0],
        "sim_from_gp_1d": lambda t: s1.run(kcsd=True, device=dev, timings=t)[0],
        "sim_from_gp_1d_fix": lambda t: s1.run(fix=True, kcsd=True, device=dev, timings=t)[0],
        "sim_from_gp_1d_mismatch": lambda t: mm.run(device=dev, timings=t),
    }
    out, m, by_shape = {}, {}, {}
    for name, fn in runs.items():
        stages = {}
        m[name], seconds, launches, shapes = run_counted(qf, lambda: fn(stages))
        out[name] = {"seconds": seconds, "stages": stages, "launches": launches,
                     "launches_by_shape": {shape_key(k): v for k, v in shapes.items()},
                     "metrics": m[name]}
        by_shape = merge_counts(by_shape, shapes)
    emit("workloads_sim", card=smi, **out)
    t, f1, fx, mmm = (m[k] for k in runs)
    check(t["white_noise_gpcsd_r2"] > 0.9 and t["white_noise_gpcsd_mse"] < t["white_noise_tcsd_mse"]
          and 50 < t["white_noise_fitted_R"] < 600, "workloads_sim: simple template")
    check(f1["gpcsd_mse_mean"] < f1["tcsd_mse_mean"] and f1["paired_p_gp_vs_tcsd"] < 0.01
          and f1["gpcsd_r2_mean"] > 0.8, "workloads_sim: sim_from_gp_1d fit vs tCSD")
    check(fx["gpcsd_r2_mean"] > 0.85 and fx["fitted_R"] == 100.0, "workloads_sim: oracle")
    for r in (f1, fx):
        check(np.isfinite(r["kcsd_R"]) and r["kcsd_lambda"] > 0, "workloads_sim: kCSD selection")
    check(fx["gpcsd_mse_mean"] < fx["kcsd_mse_mean"] and fx["paired_p_gp_vs_kcsd"] < 0.05,
          "workloads_sim: oracle vs kCSD")
    check(mmm["mse_2comp_fit2"] < 0.05 and mmm["mse_2comp_fit1"] < 0.5, "workloads_sim: mismatch MSE")
    check(mmm["loo_best_stack"] == "2comp" and np.isfinite(mmm["loo_elpd_1comp"])
          and np.isfinite(mmm["loo_elpd_2comp"]), "workloads_sim: mismatch LOO")
    check(out["simple_template_1d"]["launches_by_shape"].get(shape_key(SHAPE_TEMPLATE), 0) > 0
          and out["sim_from_gp_1d"]["launches_by_shape"].get(shape_key(SHAPE_SIM1D), 0) > 0
          and out["sim_from_gp_1d_fix"]["launches"] == 0
          and out["sim_from_gp_1d_mismatch"]["launches_by_shape"].get(shape_key(SHAPE_MISMATCH), 0) > 0,
          f"workloads_sim: launches {by_shape}")
    return by_shape


def phase_workloads_2d(qf, dev, smi):
    """``sim_from_gp_2d`` and ``neuropixels`` on the card at their JAX
    defaults (the Neuropixels twin: 20 restarts, ngl 30 x 120, nt 150, 40
    trials, nboot 1000) with the JAX tests' thresholds, and peak device
    memory.  Returns the launches by shape."""
    from gpcsd_tpu_torch.workloads import neuropixels as npx
    from gpcsd_tpu_torch.workloads import sim_from_gp_2d as s2

    out, by_shape = {}, {}
    t2, tn = {}, {}
    for name, fn, stages in (("sim_from_gp_2d", lambda: s2.run(device=dev, timings=t2)[0], t2),
                             ("neuropixels", lambda: npx.run(n_restarts=NPX_RESTARTS,
                                                             nboot=NPX_NBOOT, device=dev,
                                                             timings=tn), tn)):
        torch.cuda.reset_peak_memory_stats()
        metrics, seconds, launches, shapes = run_counted(qf, fn)
        out[name] = {"seconds": seconds, "stages": stages, "launches": launches,
                     "launches_by_shape": {shape_key(k): v for k, v in shapes.items()},
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(), "metrics": metrics}
        by_shape = merge_counts(by_shape, shapes)
    m2, mn = out["sim_from_gp_2d"]["metrics"], out["neuropixels"]["metrics"]
    emit("workloads_2d", card=smi, restarts=NPX_RESTARTS, nboot=NPX_NBOOT,
         probe_trials_kept={p: mn[f"{p}_trials_kept"] for p in npx.PROBES}, **out)
    check(m2["oracle_r2"] > 0.6 and np.isfinite(m2["fitted_rmse"]), "workloads_2d: sim_from_gp_2d")
    check(mn["source"] == "surrogate", "workloads_2d: neuropixels source")
    for p in npx.PROBES:
        check(mn[f"{p}_csd_pred_shape"] == [4, NPX_NT, mn[f"{p}_trials_kept"]] and np.isfinite(mn[f"{p}_R"]),
              f"workloads_2d: neuropixels {p}")
    for tag in ("tg_3_7_t0", "tg_3_7_t70", "tg_15_25_t0", "tg_15_25_t70"):
        w = mn.get(f"{tag}_pplv_ci_width_mean", np.nan)
        check(f"{tag}_edges_bonf" in mn and np.isfinite(w) and 0.0 <= w <= 1.0,
              f"workloads_2d: torus graph {tag}")
    check(by_shape.get(SHAPE_SIM2D, 0) > 0 and npx_shapes(by_shape), f"workloads_2d: launches {by_shape}")
    return by_shape


# ------------------------------------------- parallel/: the (chain, trial) mesh

#: the block each of two trial ranks holds of the main path's 100 trials
SHAPE_SHARDED = (24, 600, 50)
#: the parallel phase's runs: (a) world size 1, (b) two ranks on the card
PAR_POSTERIOR = dict(n_chains=2, num_warmup=5, num_samples=5, max_depth=5)
PAR_NUTS = dict(seed=0, n_chains=2, num_warmup=3, num_samples=3, max_depth=5)
PAR_MAP = dict(seed=0, n_restarts=2, maxiter=10, ftol=1e7 * np.finfo(float).eps)
PAR_SMC = dict(seed=0, n_particles=32, n_mutation_steps=2, max_stages=3)
PAR_ADVI = dict(num_steps=12, n_mc=8)
#: sharded against unsharded on the card: value (relative), gradient with
#: one trial rank and, over two, the gradient and its temporal components
#: (relative, in norm), MAP NLL (relative), SMC
#: temperatures and evidence increments (relative), ADVI trace at world size
#: 1 (relative), and the two ranks' reduced value and gradient against the
#: sum of the two blocks' terms computed in one process ("blocks").  With one
#: trial rank the arithmetic is the unsharded one, bit for bit.  Split over
#: two trial ranks, the gradient moves by the roundoff of another order of
#: the trial sum times the gap-regularized eigh backward's amplification
#: (up to 1e12, the inverse of its regularization, inside the clusters of
#: near-equal eigenvalues of Ks and Kt): H100 readings 7.2e-5 in norm, 3.0e-9
#: on the temporal part (a CPU rehearsal at nt=100: 8.3e-6, 8.5e-12).  The
#: unsharded gradient carries the same noise (the log_prob phase's
#: card-vs-CPU bounds); these limits leave a factor of 14 and 300.  The MAP
#: over two trial ranks follows that gradient, so its path is compared at
#: (chain=2, trial=1) and held to consistency at (1, 2).
TOL_PAR = {"value": 1e-12, "grad_one_rank": 1e-10, "grad": 1e-3, "grad_temporal": 1e-6,
           "map_nll": 1e-8, "smc": 1e-9, "advi": 1e-9, "blocks": 1e-14}


def par_points(u_center):
    """The banked centre and 3 jitters of it (sd 1e-3 in u)."""
    rng = np.random.default_rng(7)
    return np.vstack([u_center, u_center + 1e-3 * rng.standard_normal((3, u_center.size))])


def rel_rows(a, b):
    """Largest relative difference of the rows of ``a`` and ``b`` in norm."""
    a, b = torch.atleast_2d(a), torch.atleast_2d(b)
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def sharded_value_grad(qf, fns, Y, mesh, us):
    """Value and gradient of the sharded log-joint at the rows of ``us``
    against ``fns.log_prob`` on the card.  Returns (value rel. error,
    gradient rel. error in norm, the same of its temporal components,
    launches by shape of the sharded call, the value and the gradient)."""
    from gpcsd_tpu_torch.models.core import value_and_grad_rows
    from gpcsd_tpu_torch.parallel import mesh as M
    from gpcsd_tpu_torch.parallel import sharded as S

    Yb = M.shard_trials(mesh, Y)
    lp = S.make_trial_sharded_log_prob(fns, Y.shape[0], mesh)
    u = torch.as_tensor(us, device=Y.device)
    (v, g), _, _, by_shape = run_counted(qf, lambda: value_and_grad_rows(lambda x: lp(x, Yb), u))
    v0, g0 = value_and_grad_rows(lambda x: fns.log_prob(x, Y), u)
    return (float(((v - v0).abs() / v0.abs()).max()), rel_rows(g, g0),
            rel_rows(g[:, 2:6], g0[:, 2:6]), by_shape, v, g)


def blocks_value_grad(fns, Y, n_blocks, us):
    """The sharded log-joint's value and gradient at the rows of ``us``
    computed in one process: each trial block's term (its quadratic term,
    and its share of the log-determinant and prior, as
    ``make_trial_sharded_log_prob`` forms it) differentiated alone, and the
    values and gradients summed, which is what the all-reduces do."""
    from gpcsd_tpu_torch.models.core import value_and_grad_rows
    from gpcsd_tpu_torch.ops import kronlik

    n = Y.shape[0]

    def term(x, Yl):
        fac = fns.build_factors(fns.param_set.unpack(x))
        logdet = n * (torch.sum(torch.log(fac.d), dim=(-2, -1)) + fac.logdet_offset)
        return -0.5 * (logdet / n_blocks + kronlik.quad_term(fac, Yl)) + fns.log_prior_u(x) / n_blocks

    u = torch.as_tensor(us, device=Y.device)
    parts = [value_and_grad_rows(lambda x: term(x, Yl), u) for Yl in Y.chunk(n_blocks)]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def collective_ms(group, dim, dev, reps=50):
    """Milliseconds of the collectives of one value+grad of one row: an
    all-reduce of the value and one of the (1, dim) gradient over
    ``group``, synchronised, after a warm-up."""
    import torch.distributed as dist

    a = torch.zeros(1, dtype=torch.float64, device=dev)
    b = torch.zeros(1, dim, dtype=torch.float64, device=dev)
    for _ in range(5):
        dist.all_reduce(a, group=group)
        dist.all_reduce(b, group=group)
    _, seconds = sync_seconds(lambda: [(dist.all_reduce(a, group=group),
                                        dist.all_reduce(b, group=group)) for _ in range(reps)])
    return 1e3 * seconds / reps


def phase_parallel_ws1(qf, gpu, us, smi):
    """(a) The one-card user's path: a process group of one rank over NCCL
    and the default mesh.  The sharded value+grad at ``us`` against the
    unsharded one, ``sample_posterior(mesh=)`` from prior draws, and
    ``advi(mesh=)`` against ``advi()``.  Returns the launches by shape of
    the sharded calls."""
    import torch.distributed as dist
    from gpcsd_tpu_torch.models.core import value_and_grad_rows
    from gpcsd_tpu_torch.parallel import mesh as M
    from gpcsd_tpu_torch.parallel import sharded as S

    fns, Y = gpu._fns(), gpu._Y()
    t0 = time.perf_counter()
    M.init_distributed(num_processes=1)
    try:
        mesh = M.make_mesh(device_type=Y.device.type)
        val, grad, grad_t, by_vg, _, _ = sharded_value_grad(qf, fns, Y, mesh, us)
        Yb = M.shard_trials(mesh, Y)
        lp = S.make_trial_sharded_log_prob(fns, Y.shape[0], mesh)
        u1 = torch.as_tensor(us[:1], device=Y.device)
        sharded = lambda: value_and_grad_rows(lambda x: lp(x, Yb), u1)  # noqa: E731
        plain = lambda: value_and_grad_rows(lambda x: fns.log_prob(x, Y), u1)  # noqa: E731
        runs = [1e3 * np.mean([sync_seconds(f)[1] for _ in range(5)])
                for f in (plain, sharded, sharded, plain)]
        coll = collective_ms(mesh.get_group("trial"), us.shape[1], Y.device)
        post, post_s, _, by_post = run_counted(qf, lambda: gpu.sample_posterior(mesh=mesh, **PAR_POSTERIOR))
        adv, adv_s, _, by_advi = run_counted(qf, lambda: gpu.advi(mesh=mesh, **PAR_ADVI))
        adv_trace = adv.diagnostics["elbo"]
        want = gpu.advi(**PAR_ADVI).diagnostics["elbo"]
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    samples = post.raw.samples.cpu().numpy()
    advi_rel = float(np.max(np.abs(adv_trace - want) / np.abs(want)))
    launches = {"value_grad": sum(by_vg.values()), "sample_posterior": sum(by_post.values()),
                "advi": sum(by_advi.values())}
    emit("parallel_ws1", card=smi, backend="nccl", world_size=1, seconds=seconds,
         value_rel_err=val, grad_rel_err=grad, grad_temporal_rel_err=grad_t,
         value_grad_ms_unsharded=runs[::3],
         value_grad_ms_sharded=runs[1:3], collective_ms_per_value_grad=coll,
         sample_posterior_seconds=post_s, sample_posterior_shape=list(samples.shape),
         advi_seconds=adv_s, advi_trace_rel_err_vs_unsharded=advi_rel, launches=launches)
    check(val <= TOL_PAR["value"], f"parallel_ws1: sharded value off by {val}")
    check(grad <= TOL_PAR["grad_one_rank"], f"parallel_ws1: sharded gradient off by {grad}")
    check(samples.shape == (2, 5, us.shape[1]) and np.isfinite(samples).all(),
          f"parallel_ws1: sample_posterior(mesh=) draws of shape {samples.shape} or not finite")
    check(np.isfinite(adv_trace).all(), "parallel_ws1: an ELBO of advi(mesh=) is not finite")
    check(advi_rel <= TOL_PAR["advi"], f"parallel_ws1: advi(mesh=) trace off by {advi_rel}")
    check(all(launches.values()), f"parallel_ws1: a sharded call launched no kernel: {launches}")
    return merge_counts(by_vg, by_post, by_advi)


def _parallel_rank(rank, device, init_file, lfp, time_ms, us, results):
    """One of the two ranks of :func:`phase_parallel_ranks`; puts its dict
    (or its traceback) on ``results``."""
    import traceback

    import torch.distributed as dist

    try:
        results.put(_parallel_rank_cases(rank, device, init_file, lfp, time_ms, us))
    except BaseException:
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _parallel_rank_cases(rank, device, init_file, lfp, time_ms, us):
    """(b) on one rank of two, gloo with the card's tensors: the sharded
    value+grad, MAP and ADVI at (chain=1, trial=2), MAP, SMC and NUTS at
    (2, 1); rank 0 also runs each unsharded twin from the same starts and
    random numbers.  At (2, 1) a rank runs one restart or chain, so their
    twins run one at a time: cuSOLVER factors a batch of small matrices
    (Ks, 24 x 24) by another algorithm than a single one, which would move
    the last bits."""
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from gpcsd_tpu_torch import paper
    from gpcsd_tpu_torch.infer.advi import advi_fit
    from gpcsd_tpu_torch.infer.lbfgs import lbfgs_minimize
    from gpcsd_tpu_torch.infer.map import sample_restarts
    from gpcsd_tpu_torch.models import pass_graphs
    from gpcsd_tpu_torch.infer.nuts import chain_generators, nuts_chains
    from gpcsd_tpu_torch.infer.smc import smc_run
    from gpcsd_tpu_torch.models.inference_api import prior_starts, stream_generator
    from gpcsd_tpu_torch.ops.cuda import eigh as ej
    from gpcsd_tpu_torch.ops.cuda import quadform as qf
    from gpcsd_tpu_torch.parallel import mesh as M
    from gpcsd_tpu_torch.parallel import sharded as S

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    M.init_distributed(f"file://{init_file}", 2, rank, backend="gloo")
    # gloo must take the card's tensors for both collectives the drivers use
    x = torch.full((3,), rank + 1.0, dtype=torch.float64, device=dev)
    dist.all_reduce(x)
    parts = [torch.empty(2, dtype=torch.float64, device=dev) for _ in range(2)]
    dist.all_gather(parts, torch.full((2,), float(rank), dtype=torch.float64, device=dev))
    check(x.device == dev and x.tolist() == [3.0] * 3, f"gloo all_reduce on {dev} gave {x}")
    check(all(p.device == dev for p in parts) and [p.tolist() for p in parts] == [[0.0] * 2, [1.0] * 2],
          f"gloo all_gather on {dev} gave {parts}")

    model = paper.build_model(lfp, time_ms, het_noise="exact", device=dev)
    fns, Y = model._fns(), model._Y()
    mesh12 = M.make_mesh(chain=1, trial=2, device_type=dev.type)
    mesh21 = M.make_mesh(chain=2, trial=1, device_type=dev.type)
    out, by_phase, seconds = {"rank": rank}, {}, {}
    (out["value_rel_err"], out["grad_rel_err"], out["grad_temporal_rel_err"],
     by_phase["value_grad"], v, g) = sharded_value_grad(qf, fns, Y, mesh12, us)
    out["value_grad"] = (v.cpu().numpy(), g.cpu().numpy())
    out["collective_ms_per_value_grad"] = collective_ms(mesh12.get_group("trial"), us.shape[1], dev)
    runs = {
        "map12": lambda: S.map_fit_sharded(fns, Y, mesh12, **PAR_MAP),
        "advi12": lambda: S.advi_sharded(fns, Y, mesh12, 0, **PAR_ADVI),
        "map21": lambda: S.map_fit_sharded(fns, Y, mesh21, **PAR_MAP),
        "smc21": lambda: S.smc_sharded(fns, Y, mesh21, chunk=16, **PAR_SMC),
        "nuts21": lambda: S.nuts_sharded(fns, Y, mesh21, **PAR_NUTS),
    }
    res = {}
    for name, fn in runs.items():
        res[name], seconds[name], _, by_phase[name] = run_counted(qf, fn)
    out["by_phase"], out["seconds"] = by_phase, seconds
    out["map12_u"], out["map12_nll"] = res["map12"]
    out["map21_nll"] = res["map21"][1]
    out["advi12_trace"] = res["advi12"].elbo_trace.cpu().numpy()
    out["smc21_temperatures"] = res["smc21"].temperatures.cpu().numpy()
    out["smc21_increments"] = res["smc21"].log_evidence_increments.cpu().numpy()
    out["nuts21_samples"] = res["nuts21"].samples.cpu().numpy()
    out["eigh_jacobi_launches"] = dict(ej.launches_by_order)
    if rank != 0:
        return out
    # the unsharded twins
    vb, gb = blocks_value_grad(fns, Y, 2, us)
    out["blocks_value_rel_err"] = float(((v - vb).abs() / vb.abs()).max())
    out["blocks_grad_rel_err"] = rel_rows(g, gb)
    lo, hi = fns.param_set.bounds()
    u0s = torch.as_tensor(sample_restarts(fns.param_set, np.random.default_rng(PAR_MAP["seed"]),
                                          PAR_MAP["n_restarts"]), device=dev)

    def lbfgs(u):
        # the sharded log-prob runs the log-joint's eager arithmetic, so its
        # twin does too: a pass through the CUDA graphs
        # (models/pass_graphs.py) sums u's gradient in another order, and an
        # L-BFGS path carries that last bit to ~5e-7 in the final NLL
        eligible = pass_graphs.eligible
        pass_graphs.eligible = lambda u: False
        try:
            res = lbfgs_minimize(lambda x: -fns.log_prob(x, Y), u, lo=lo, hi=hi,
                                 max_iter=PAR_MAP["maxiter"], ftol=PAR_MAP["ftol"])
        finally:
            pass_graphs.eligible = eligible
        return torch.where(res.failed, torch.inf, res.f).cpu().numpy()

    with torch.no_grad():
        out["map_nll_start"] = (-fns.log_prob(u0s, Y)).cpu().numpy()
        out["map12_nll_at_u"] = (-fns.log_prob(torch.as_tensor(out["map12_u"], device=dev), Y)
                                 ).cpu().numpy()
    out["map_nll_unsharded"] = lbfgs(u0s)
    out["map_nll_unsharded_one_by_one"] = np.concatenate([lbfgs(u[None]) for u in u0s])
    out["advi_trace_unsharded"] = advi_fit(
        lambda u: fns.log_prob(u, Y), torch.as_tensor(prior_starts(fns, 0, 1)[0], device=dev),
        stream_generator(0, 1), **PAR_ADVI).elbo_trace.cpu().numpy()
    seed, n = PAR_SMC["seed"], PAR_SMC["n_particles"]
    smc = smc_run(fns.log_prior_u, lambda u: fns.loglik(fns.param_set.unpack(u), Y),
                  torch.as_tensor(prior_starts(fns, seed, n), device=dev), stream_generator(seed, 1),
                  n_mutation_steps=PAR_SMC["n_mutation_steps"], max_stages=PAR_SMC["max_stages"],
                  chunk=16)
    out["smc_temperatures_unsharded"] = smc.temperatures.cpu().numpy()
    out["smc_increments_unsharded"] = smc.log_evidence_increments.cpu().numpy()
    seed, n = PAR_NUTS["seed"], PAR_NUTS["n_chains"]
    kw = {k: v for k, v in PAR_NUTS.items() if k not in ("seed", "n_chains")}
    u0s, gens = torch.as_tensor(prior_starts(fns, seed, n), device=dev), chain_generators(seed, n)
    out["nuts_samples_unsharded_one_by_one"] = np.concatenate([
        nuts_chains(lambda u: fns.log_prob(u, Y), u0s[i:i + 1], gens[i:i + 1], **kw
                    ).samples.cpu().numpy() for i in range(n)])
    return out


def max_rel_diff(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def phase_parallel_ranks(lfp, time_ms, us, dev, smi, timeout=600.0):
    """(b) Two ranks spawned on the one card (NCCL refuses two ranks on one
    GPU, so gloo with the card's tensors): :func:`_parallel_rank_cases` on
    each, checked here.  Returns the ranks' launches by run and by shape,
    and their ``eigh_jacobi`` launches by order."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_parallel_rank,
                             args=(r, str(dev), init_file, lfp, time_ms, us, results))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        out = []
        try:
            while len(out) < len(procs):  # drain before joining; stop at a failure
                out.append(results.get(timeout=timeout))
                check("error" not in out[-1],
                      f"parallel rank {out[-1]['rank']} failed:\n{out[-1].get('error')}")
        except queue.Empty:
            raise RuntimeError(f"parallel: {2 - len(out)} ranks did not report in {timeout} s") from None
        finally:
            for p in procs:
                p.join(timeout=30 if len(out) == len(procs) else 0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
        seconds = time.perf_counter() - t0
    r0, r1 = sorted(out, key=lambda o: o["rank"])
    ladder_same = r0["smc21_temperatures"].shape == r0["smc_temperatures_unsharded"].shape
    smc_t = smc_i = float("inf")
    if ladder_same:
        smc_t = max_rel_diff(r0["smc21_temperatures"], r0["smc_temperatures_unsharded"])
        smc_i = max_rel_diff(r0["smc21_increments"], r0["smc_increments_unsharded"])
    fields = dict(
        value_rel_err=max(r0["value_rel_err"], r1["value_rel_err"]),
        grad_rel_err=max(r0["grad_rel_err"], r1["grad_rel_err"]),
        grad_temporal_rel_err=max(r0["grad_temporal_rel_err"], r1["grad_temporal_rel_err"]),
        blocks_value_rel_err=r0["blocks_value_rel_err"], blocks_grad_rel_err=r0["blocks_grad_rel_err"],
        map21_nll_rel_err=max_rel_diff(r0["map21_nll"], r0["map_nll_unsharded_one_by_one"]),
        map12_nll_rel_diff_vs_unsharded=max_rel_diff(r0["map12_nll"], r0["map_nll_unsharded"]),
        map12_nll_rel_err_vs_log_prob=max_rel_diff(r0["map12_nll"], r0["map12_nll_at_u"]),
        advi12_trace_rel_diff_vs_unsharded=max_rel_diff(r0["advi12_trace"],
                                                        r0["advi_trace_unsharded"]),
        smc21_temperature_rel_err=smc_t, smc21_increment_rel_err=smc_i,
        nuts21_max_abs_diff_vs_unsharded=float(np.max(np.abs(
            r0["nuts21_samples"] - r0["nuts_samples_unsharded_one_by_one"]))),
    )
    by_phase = {ph: merge_counts(r0["by_phase"][ph], r1["by_phase"][ph]) for ph in r0["by_phase"]}
    ej_launches = merge_counts(r0["eigh_jacobi_launches"], r1["eigh_jacobi_launches"])
    emit("parallel_ranks", card=smi, backend="gloo", world_size=2, seconds=seconds, **fields,
         collective_ms_per_value_grad=[r0["collective_ms_per_value_grad"],
                                       r1["collective_ms_per_value_grad"]],
         map_nll_start=r0["map_nll_start"].tolist(), map12_nll=r0["map12_nll"].tolist(),
         map_nll_unsharded=r0["map_nll_unsharded"].tolist(),
         map_nll_unsharded_one_by_one=r0["map_nll_unsharded_one_by_one"].tolist(),
         smc21_stages=r0["smc21_temperatures"].size,
         run_seconds=r0["seconds"],
         launches_by_run={ph: {shape_key(k): v for k, v in d.items()} for ph, d in by_phase.items()},
         eigh_jacobi_launches=ej_launches)
    for k in ("value", "grad", "grad_temporal"):
        check(fields[f"{k}_rel_err"] <= TOL_PAR[k], f"parallel_ranks: sharded {k} off by "
              f"{fields[f'{k}_rel_err']}")
    for k in ("blocks_value", "blocks_grad"):
        check(fields[f"{k}_rel_err"] <= TOL_PAR["blocks"], f"parallel_ranks: sharded {k} off by "
              f"{fields[f'{k}_rel_err']}")
    check(all(np.array_equal(a, b) for a, b in zip(r0["value_grad"], r1["value_grad"])),
          "parallel_ranks: the two ranks' value or gradient differ")
    for k in ("map12_u", "map12_nll", "map21_nll", "advi12_trace", "smc21_temperatures",
              "smc21_increments", "nuts21_samples"):
        check(np.array_equal(r0[k], r1[k]), f"parallel_ranks: the two ranks' {k} differ")
    check(fields["map21_nll_rel_err"] <= TOL_PAR["map_nll"],
          f"parallel_ranks: MAP at (2, 1) off by {fields['map21_nll_rel_err']}")
    check(np.all(r0["map12_nll"] <= r0["map_nll_start"]), "parallel_ranks: a MAP restart rose")
    check(fields["map12_nll_rel_err_vs_log_prob"] <= 1e-12,
          "parallel_ranks: the MAP's reported NLL is not -log_prob at its u")
    check(np.isfinite(r0["advi12_trace"]).all(), "parallel_ranks: an ELBO of advi_sharded is not finite")
    check(ladder_same and smc_t <= TOL_PAR["smc"] and smc_i <= TOL_PAR["smc"],
          f"parallel_ranks: SMC ladder or increments off ({smc_t}, {smc_i})")
    check(np.isfinite(r0["nuts21_samples"]).all(), "parallel_ranks: a NUTS draw is not finite")
    return by_phase, ej_launches


# ------------------------------------- the bench twins and the 2D posterior

#: the banked port paper run's numbers, which the bench's artifact route
#: must return
BANKED_RATE, BANKED_LEAPFROGS = 11.432655392025252, 7.0
#: the 2D probe's run in phase nuts_2d: chains, warmup, samples, max_depth
NUTS_2D = {"--chains": "4", "--warmup": "8", "--samples": "6", "--max-depth": "6"}
#: the 2D probe's Laplace Hessian, card vs CPU, as a share of max |H|: over
#: the whole matrix and away from the spatial rows (R, ell1, ell2).  The
#: spatial gradient carries each eigensolver's placement of the Gram's
#: roundoff-level eigenvalues, which the stencil divides by 2h = 2e-4.  H100
#: readings at the probe's surrogate: 4.6e-5 and 8.9e-12 (max |H| 1.18e6);
#: each limit leaves a factor of ~10
TOL_HESSIAN_2D = {"all": 5e-4, "rest": 1e-10}


def phase_bench(qf, dev, smi):
    """``gpcsd_tpu_torch.bench`` (the twin of ``bench.py``) at its point:
    evals/s over 5 repeats of 50 distinct points (median, quartiles, the
    events' ms per evaluation), the numpy baseline, the NUTS line from the
    banked paper run and, forced with ``paths=[]``, from the live 4 x (40 +
    40) run.  Returns the launches and the median evals/s."""
    from gpcsd_tpu_torch import bench
    from gpcsd_tpu_torch.infer import nuts

    m = bench.build_problem(device=dev)
    qf.launch_count = 0
    qf.launches_by_shape.clear()
    res = bench.bench_evals_per_s(m)
    launches_evals = qf.launch_count
    base = bench.bench_baseline(m)
    art = bench.bench_nuts(base)
    nuts.evaluations = 0
    before = qf.launch_count
    t0 = time.perf_counter()
    live = bench.bench_nuts(base, paths=[], device=dev)
    live_s = time.perf_counter() - t0
    live_launches, live_evals = qf.launch_count - before, nuts.evaluations
    launches, shapes = qf.launch_count, dict(qf.launches_by_shape)
    hessian_rows = 2 * len(m._fns().param_set.names_flat())
    line = lambda nl: {k: v for k, v in nl._asdict().items()}  # noqa: E731
    emit("bench", card=smi, evals_per_s_median=res["median"], evals_per_s_q25=res["q25"],
         evals_per_s_q75=res["q75"], evals_per_s_repeats=[r["evals_per_s"] for r in res["repeats"]],
         event_ms_per_eval=res["event_ms_per_eval"],
         event_ms_per_eval_repeats=[r["event_ms_per_eval"] for r in res["repeats"]],
         first_call_s=res["first_call_s"], evals=res["evals"], launches_evals=launches_evals,
         numpy_baseline_evals_per_s=base, vs_baseline=res["median"] / base,
         artifact_route=line(art), live_route=line(live), live_seconds=live_s,
         live_launches=live_launches, live_sampler_evaluations=live_evals, launches=launches)
    check(launches_evals == res["launches"] == res["evals"],
          f"bench: {launches_evals} launches for {res['evals']} evaluations")
    check(len(np.unique(res["points"], axis=0)) == 50, "bench: the 50 points are not distinct")
    check(abs(art.rate - BANKED_RATE) < 1e-9 and art.steps == BANKED_LEAPFROGS
          and (art.max_depth, art.chunk_size) == (7, 1),
          f"bench: the artifact route gave {art}")
    check((live.rate is None and len(live.failures) > 0)
          or (live.rate is not None and live.rate > 0 and not live.failures),
          f"bench: the live route gave rate {live.rate} with failures {live.failures}")
    check(live_launches == live_evals + hessian_rows > hessian_rows,
          f"bench: {live_launches} live launches for {live_evals} sampler evaluations "
          f"and {hessian_rows} Hessian rows")
    check(set(shapes) == {SHAPE_1D}, f"bench: launches at {shapes}")
    return launches, res["median"]


def phase_bench_2d(qf, gpu, cpu, smi):
    """``gpcsd_tpu_torch.bench.bench_2d`` (the twin of ``scripts/bench_2d.py``)
    at the Neuropixels point, its numpy baseline, and its last value against
    the CPU's (``TOL_2D``'s value limit)."""
    from gpcsd_tpu_torch import bench

    qf.launch_count = 0
    res = bench.bench_2d(gpu)
    launches = qf.launch_count
    base = bench.bench_baseline_2d(gpu)
    with torch.no_grad():
        v_cpu = float(cpu._fns().neg_log_joint(torch.as_tensor(res["points"][-1]), cpu._Y()))
    err = rel(res["value"], v_cpu)
    emit("bench_2d", card=smi, evals_per_s_median=res["median"], evals_per_s_q25=res["q25"],
         evals_per_s_q75=res["q75"], evals_per_s_repeats=[r["evals_per_s"] for r in res["repeats"]],
         event_ms_per_eval=res["event_ms_per_eval"], first_call_s=res["first_call_s"],
         neg_log_joint=res["value"], neg_log_joint_cpu=v_cpu, rel_err=err, evals=res["evals"],
         numpy_baseline_evals_per_s=base, vs_baseline=res["median"] / base, launches=launches)
    check(launches == res["evals"], f"bench_2d: {launches} launches for {res['evals']} evaluations")
    check(err <= TOL_2D["value"], f"bench_2d: card vs CPU {err} above {TOL_2D['value']}")
    return launches


def phase_nuts_2d(qf, dev, smi, tmp):
    """The 2D probe's twin (``gpcsd_tpu_torch.nuts_2d_probe``) at full width
    in ``tmp``: its prep (surrogate and Laplace Hessian on the card), the
    Hessian against the CPU's, then dense-mass NUTS 4 x (8 + 6) at max_depth
    6 from the generating point.  Health is reported, not required.
    Returns the launches and the probe's model on the CPU."""
    from gpcsd_tpu_torch import nuts_2d_probe as probe
    from gpcsd_tpu_torch.infer import nuts
    from gpcsd_tpu_torch.models.inference_api import laplace_hessian

    args = ["--out-dir", tmp, "--device", str(dev), "--dense-mass",
            *(a for kv in NUTS_2D.items() for a in kv)]
    qf.launch_count = 0
    qf.launches_by_shape.clear()
    t0 = time.perf_counter()
    rc_prep = probe.main([*args, "--prep-only"])
    prep_s = time.perf_counter() - t0
    launches_prep = qf.launch_count
    with np.load(os.path.join(tmp, "hessian_f64_2d.npz")) as d:
        H_card, u0 = d["H"], d["u0"]
    cpu = probe.build_probe_model(tmp, 0, device="cpu")
    t0 = time.perf_counter()
    H_cpu = laplace_hessian(cpu._fns(), u0, cpu._Y())
    cpu_s = time.perf_counter() - t0
    scale = np.max(np.abs(H_cpu))
    h_err = {"all": float(np.max(np.abs(H_card - H_cpu)) / scale),
             "rest": float(np.max(np.abs(H_card[3:, 3:] - H_cpu[3:, 3:])) / scale)}
    qf.launch_count = 0
    qf.launches_by_shape.clear()
    nuts.evaluations = 0
    t0 = time.perf_counter()
    rc = probe.main(args)
    seconds = time.perf_counter() - t0
    launches, evals, shapes = qf.launch_count, nuts.evaluations, dict(qf.launches_by_shape)
    with open(os.path.join(tmp, "nuts_2d_probe.json")) as f:
        art = json.load(f)
    with np.load(os.path.join(tmp, "posterior_samples_2d.npz")) as d:
        draws = d["raw_u"]
    emit("nuts_2d", card=smi, exit_codes=[rc_prep, rc], prep_seconds=prep_s,
         hessian_cpu_seconds=cpu_s, hessian_max_abs=scale, hessian_rel_err=h_err,
         hessian_eigs=np.linalg.eigvalsh(H_card).tolist(), seconds=seconds,
         launches_prep=launches_prep, launches=launches, sampler_evaluations=evals,
         **{k: art[k] for k in ("samples_per_s_per_chip_median", "median_sampling_transition_s",
                                "mean_leapfrogs_per_sample", "mean_acceptance", "divergences",
                                "max_rhat", "min_ess", "min_ess_tail", "step_size", "healthy",
                                "gate_failures", "config")})
    check([rc_prep, rc] == [0, 0], f"nuts_2d: exit codes {[rc_prep, rc]}")
    check(launches_prep == 2 * u0.size, f"nuts_2d: {launches_prep} launches for the Hessian")
    for key, tol in TOL_HESSIAN_2D.items():
        check(h_err[key] <= tol, f"nuts_2d: Hessian card vs CPU ({key}) {h_err[key]} above {tol}")
    check(launches == evals > 0, f"nuts_2d: {launches} launches for {evals} sampler evaluations")
    check(set(shapes) == {SHAPE_2D}, f"nuts_2d: launches at {shapes}")
    check((art["samples_per_s_per_chip_median"] is None) == bool(art["gate_failures"]),
          "nuts_2d: the artifact's rate and its gate disagree")
    check(draws.shape == (4, 6, u0.size) and np.all(np.isfinite(draws)),
          f"nuts_2d: draws of shape {draws.shape}, finite {np.all(np.isfinite(draws))}")
    return launches_prep + launches, cpu


def phase_noise_2d(qf, dev, cpu, tmp, smi):
    """The likelihood noise probe (``noise_probe.probe``, 33 points over a
    segment of half-width 1e-2) on the 2D probe's surrogate at its
    generating point, card and CPU; then ``log_prob`` and its gradient card
    vs CPU at a second seed's surrogate and generating point."""
    from gpcsd_tpu_torch import noise_probe
    from gpcsd_tpu_torch import nuts_2d_probe as probe
    from gpcsd_tpu_torch.infer.map import value_and_grad

    gpu = probe.build_probe_model(tmp, 0, device=dev)
    u0 = gpu._fns().param_set.pack(gpu._theta()).cpu().numpy()
    qf.launch_count = 0
    t0 = time.perf_counter()
    card = noise_probe.probe(gpu, u0)
    card_s = time.perf_counter() - t0
    launches = qf.launch_count
    host = noise_probe.probe(cpu, u0)
    emit("noise_2d", card=smi, scale=1e-2, npts=33, launches=launches, card_seconds=card_s,
         **{f"{k}_{where}": r[k] for where, r in (("card", card), ("cpu", host))
            for k in ("rms", "max_abs_residual", "center", "range")})
    check(np.all(np.isfinite(card["logp"])) and np.all(np.isfinite(host["logp"])),
          "noise_2d: a value is not finite")
    check(launches == 33, f"noise_2d: {launches} launches for 33 evaluations")
    # the second seed: the CPU draws the surrogate, the card reads its cache
    tmp1 = os.path.join(tmp, "seed1")
    os.makedirs(tmp1)
    cpu1 = probe.build_probe_model(tmp1, 1, device="cpu")
    gpu1 = probe.build_probe_model(tmp1, 1, device=dev)
    u1 = cpu1._fns().param_set.pack(cpu1._theta()).cpu().numpy()
    before = qf.launch_count
    v, g = value_and_grad(lambda ut: gpu1._fns().log_prob(ut, gpu1._Y()), u1, dev)
    launches_seed1 = qf.launch_count - before
    vc, gc = value_and_grad(lambda ut: cpu1._fns().log_prob(ut, cpu1._Y()), u1, "cpu")
    emit("noise_2d_seed1", card=smi, log_prob_card=v, log_prob_cpu=vc, value_abs_err=abs(v - vc),
         value_rel_err=rel(v, vc), grad_rel_err=rel_norm(g, gc))
    check(np.isfinite(v) and np.all(np.isfinite(g)), "noise_2d: seed 1 log_prob is not finite")
    check(launches_seed1 == 1, f"noise_2d: {launches_seed1} launches for seed 1's evaluation")
    return launches + launches_seed1



def ej_counted(ej, by_phase, name, fn, *args):
    """``fn(*args)`` with the ``eigh_jacobi`` launch counts set to 0 just
    before; its launches by order go to ``by_phase[name]``."""
    ej.launch_count = 0
    ej.launches_by_order.clear()
    out = fn(*args)
    by_phase[name] = dict(ej.launches_by_order)
    return out


def npx_shapes(by_shape):
    """The Neuropixels twin's shapes among ``by_shape``'s keys."""
    return sorted(k for k in by_shape if k[:2] == (NPX_NX, NPX_NT))


def main():
    check(torch.cuda.is_available(), "CUDA is not available: this check needs a GPU")
    sys.path.insert(0, ROOT)
    from gpcsd_tpu_torch import paper
    from gpcsd_tpu_torch.infer.map import sample_restarts, value_and_grad
    from gpcsd_tpu_torch.ops.cuda import eigh as ej
    from gpcsd_tpu_torch.ops.cuda import library
    from gpcsd_tpu_torch.ops.cuda import quadform as qf
    from gpcsd_tpu_torch.utils.profiling import nvidia_smi

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda, name=name,
         count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    lib = library.build()
    seconds = time.perf_counter() - t0
    ptxas = [ln for ln in lib.with_suffix(".log").read_text().splitlines() if "ptxas" in ln]
    sass = sass_counts(lib, library.cuda_tool("cuobjdump"))
    emit("build", seconds=seconds, library=os.path.relpath(lib, ROOT), ptxas=ptxas, sass=sass)
    check(sass["DMMA"] > 0, "the kernel library holds no FP64 tensor-core (DMMA) instruction")
    check(sass["LDGSTS"] + sass["UTMALDG"] > 0, "the kernel library holds no async copy")

    abs_err = phase_kernel(qf, dev)
    ej_by_phase = {}  # phase -> {order n: eigh_jacobi launches}
    eigh_rows = ej_counted(ej, ej_by_phase, "eigh_jacobi", phase_eigh_jacobi, dev, smi)
    if sys.argv[1:] == ["eigh_jacobi"]:
        return

    # ---- the main path: counts from here to the end of the fit
    lfp, time_ms, _ = paper.paper_surrogate(0, 1200, 100, device=dev)
    banked_u = np.load(os.path.join(HETX, "posterior_samples.npz"))["raw_u"].reshape(-1, 30)
    draws = banked_u[:8]
    banked = np.load(os.path.join(HETX, "logp64_draws.npy"))[:8]
    gpu = paper.build_model(lfp, time_ms, het_noise="exact", device=dev)
    cpu = paper.build_model(lfp, time_ms, het_noise="exact", device="cpu")
    gfns, gY = gpu._fns(), gpu._Y()
    cfns, cY = cpu._fns(), cpu._Y()
    qf.launch_count = 0
    ej.launch_count = 0
    ej.launches_by_order.clear()
    worst = {"banked": 0.0, "cpu_value": 0.0, "cpu_grad": 0.0, "cpu_grad_temporal": 0.0}
    for u, want in zip(draws, banked):
        v, g = value_and_grad(lambda ut: gfns.log_prob(ut, gY), u, dev)
        vc, gc = value_and_grad(lambda ut: cfns.log_prob(ut, cY), u, "cpu")
        check(np.isfinite(v) and np.all(np.isfinite(g)), "non-finite log_prob on the card")
        worst["banked"] = max(worst["banked"], rel(v, want))
        worst["cpu_value"] = max(worst["cpu_value"], rel(v, vc))
        worst["cpu_grad"] = max(worst["cpu_grad"], rel_norm(g, gc))
        worst["cpu_grad_temporal"] = max(worst["cpu_grad_temporal"], rel_norm(g[2:6], gc[2:6]))
    # one draw's Kt (n = 600) goes to cuSOLVER alone; the draws as one batch
    # go through the block-Jacobi kernel
    with torch.no_grad():
        vb = gfns.log_prob(torch.as_tensor(draws, device=dev), gY).cpu().numpy()
    worst["batch_banked"] = float(np.max(np.abs(vb - banked) / np.abs(banked)))
    launches_log_prob = qf.launch_count
    ej_by_phase["log_prob"] = dict(ej.launches_by_order)
    emit("log_prob", draws=len(draws), launches=launches_log_prob,
         eigh_jacobi_launches=ej_by_phase["log_prob"], **worst)
    check(max(worst["banked"], worst["batch_banked"]) <= 1e-8,
          "log_prob vs banked logp64_draws.npy above 1e-8")
    check(worst["cpu_value"] <= 1e-9, "log_prob CUDA vs CPU above 1e-9")
    # the spatial (R, ell, noise) components carry ~1e-5 of eigensolver-
    # dependent regularization bias; the temporal ones do not
    check(worst["cpu_grad"] <= 1e-4, "gradient CUDA vs CPU above 1e-4 in norm")
    check(worst["cpu_grad_temporal"] <= 1e-6, "temporal gradient CUDA vs CPU above 1e-6")
    check(launches_log_prob > 0, "the log-joint did not go through the quadform kernel")
    check(ej_by_phase["log_prob"].get(NT_1D, 0) > 0, "the log-joint's Kt did not go through eigh_jacobi")
    emit("launch_count", launches=launches_log_prob)

    ej.launches_by_order.clear()
    t0 = time.perf_counter()
    res = gpu.fit(n_restarts=2, backend="scipy", seed=0, options={"maxiter": 10})
    fit_s = time.perf_counter() - t0
    launches_map = qf.launch_count
    ej_by_phase["fit"] = dict(ej.launches_by_order)
    # ---- end of the log_prob + fit stretch of the main path
    u0s = sample_restarts(gfns.param_set, np.random.default_rng(0), 2)
    nll0 = np.array([value_and_grad(lambda ut: gfns.neg_log_joint(ut, gY), u, dev)[0] for u in u0s])
    emit("fit", seconds=fit_s, nll_start=nll0.tolist(), nll_end=res.nll_values.tolist(),
         nll_best=res.nll_best, messages=res.messages, eigh_jacobi_launches=ej_by_phase["fit"])
    check(np.isfinite(res.nll_best), "MAP fit: best NLL is not finite")
    check(np.all(res.nll_values <= nll0), "MAP fit: a restart ended above its start")
    launches_map_resume = ej_counted(ej, ej_by_phase, "map_resume", phase_map_resume, qf, gpu, smi)
    check(ej_by_phase["map_resume"].get(NT_1D, 0) > 0, "the batched MAP fit's Kt did not go through eigh_jacobi")

    # before the nuts phase, whose profiler may leave its tracing cost on the
    # process's later launches
    device_ms, plain_device_ms = phase_timing(qf, dev, smi)
    launches_bench, evals_per_s = ej_counted(ej, ej_by_phase, "bench", phase_bench, qf, dev, smi)

    # ---- the 2D path at the Neuropixels shape; its profile comes last
    gpu2d = paper.neuropixels_problem(0, device=dev)
    cpu2d = paper.neuropixels_problem(0, device="cpu")
    launches_log_prob_2d = ej_counted(ej, ej_by_phase, "log_prob_2d", phase_log_prob_2d,
                                      qf, gpu2d, cpu2d)
    launches_fit_2d = ej_counted(ej, ej_by_phase, "fit_2d", phase_fit_2d, qf, paper, dev)
    check(ej_by_phase["fit_2d"].get(NT_2D, 0) > 0, "the 2D fit's Kt did not go through eigh_jacobi")
    ej_counted(ej, ej_by_phase, "predict_2d", phase_predict_2d, gpu2d, cpu2d)
    timing_2d = phase_timing_2d(qf, gpu2d, smi)
    launches_2d = {"log_prob_2d": launches_log_prob_2d, "fit_2d": launches_fit_2d,
                   "bench_2d": ej_counted(ej, ej_by_phase, "bench_2d", phase_bench_2d,
                                          qf, gpu2d, cpu2d, smi)}
    del cpu2d
    # ---- the 2D posterior: the probe's twin and the density's noise there
    tmp2d = tempfile.mkdtemp(prefix="nuts_2d_")
    try:
        launches_2d["nuts_2d"], cpu_probe = ej_counted(ej, ej_by_phase, "nuts_2d", phase_nuts_2d,
                                                       qf, dev, smi, tmp2d)
        launches_2d["noise_2d"] = ej_counted(ej, ej_by_phase, "noise_2d", phase_noise_2d,
                                             qf, dev, cpu_probe, tmp2d, smi)
    finally:
        shutil.rmtree(tmp2d, ignore_errors=True)
    del cpu_probe

    # ---- the posterior path, at the banked posterior's centre (the 2 x 10
    # MAP steps above stop far from the mode, where a Hessian is useless)
    u_center = banked_u.mean(axis=0)
    set_params(gpu, u_center)
    set_params(cpu, u_center)
    ej_counted(ej, ej_by_phase, "predict", phase_predict, gpu, cpu, time_ms)
    H, launches_hessian = ej_counted(ej, ej_by_phase, "hessian", phase_hessian,
                                     qf, gpu, cpu, u_center, banked_u)
    launches_nuts, post = ej_counted(ej, ej_by_phase, "nuts", phase_nuts,
                                     qf, gpu, H, u_center, banked_u, smi)
    check(ej_by_phase["nuts"].get(NT_1D, 0) > 0, "the sampler's Kt did not go through eigh_jacobi")
    launches_by_phase = {"log_prob": launches_log_prob, "fit": launches_map - launches_log_prob,
                         "map_resume": launches_map_resume, "bench": launches_bench,
                         "hessian": launches_hessian, "nuts": launches_nuts}

    # ---- the other posterior engines, model comparison and the paper run
    launches_by_phase["reparam"] = ej_counted(ej, ej_by_phase, "reparam", phase_reparam,
                                              qf, gpu, cpu, draws)
    launches_by_phase["advi"] = ej_counted(ej, ej_by_phase, "advi", phase_advi, qf, gpu, cpu, u_center)
    launches_by_phase["smc"] = ej_counted(ej, ej_by_phase, "smc", phase_smc, qf, gpu, cpu)
    launches_by_phase["ic"] = ej_counted(ej, ej_by_phase, "ic", phase_ic, qf, gpu, post)
    launches_by_phase["paper_run"] = ej_counted(ej, ej_by_phase, "paper_run", phase_paper_run, qf, smi)
    launches_by_phase["noise_probe"] = ej_counted(ej, ej_by_phase, "noise_probe", phase_noise_probe,
                                                  qf, gpu, cpu, lfp, time_ms, u_center, smi)
    launches_by_phase["profiling"] = ej_counted(ej, ej_by_phase, "profiling", phase_profiling,
                                                qf, dev, smi, evals_per_s)

    # ---- the analysis stages and the two workload twins
    X = phase_signal(dev, smi)
    phase_torus(X, dev, smi)
    rows_shifts, rows_err = {}, {}
    fit_fmf, rows_shifts["shifts"], rows_err[SHAPE_ROWS_SHIFT] = ej_counted(
        ej, ej_by_phase, "shifts", phase_shifts, qf, dev, smi)
    wl, rows_shifts["workloads"] = ej_counted(ej, ej_by_phase, "workloads", phase_workloads, qf, dev, smi)

    # ---- the real-data modes on written files, and the other five twins
    wl_io, rows_real = ej_counted(ej, ej_by_phase, "io", phase_io, qf, dev, smi)
    wl_sim = ej_counted(ej, ej_by_phase, "workloads_sim", phase_workloads_sim, qf, dev, smi)
    wl_2d = ej_counted(ej, ej_by_phase, "workloads_2d", phase_workloads_2d, qf, dev, smi)

    # ---- parallel/: one rank over NCCL, then two gloo ranks on the one card
    # (the kernel library is built above, so the ranks only load it)
    us_par = par_points(u_center)
    ws1 = ej_counted(ej, ej_by_phase, "parallel_ws1", phase_parallel_ws1, qf, gpu, us_par, smi)
    launches_by_phase["parallel_ws1"] = ws1.get(SHAPE_1D, 0)
    par, ej_by_phase["parallel_ranks"] = phase_parallel_ranks(lfp, time_ms, us_par, dev, smi)
    launches_by_phase["parallel_ranks"] = sum(d.get(SHAPE_1D, 0) for d in par.values())
    par_sharded = {ph: d.get(SHAPE_SHARDED, 0) for ph, d in par.items() if d.get(SHAPE_SHARDED, 0)}
    check(sum(par_sharded.values()) > 0, f"the trial-sharded block {SHAPE_SHARDED} launched no kernel")

    emit("timing_2d", **timing_2d, **profile_2d(gpu2d))
    analysis = {}
    for shape in (SHAPE_AUD, SHAPE_FMF):
        kt = kernel_times(qf, shape, dev)
        analysis[shape] = (kt["quadform_device_ms"], kt["quadform_plain_device_ms"],
                           *quadform_bound_ms(*shape))
        emit("timing_analysis", **kt)
    # the per-trial kernel at the shift stages' full batches
    rows_err[SHAPE_ROWS_REAL] = check_rows_kernel(qf, SHAPE_ROWS_REAL, dev,
                                                  torch.Generator().manual_seed(3))
    rows_times = {}
    for shape in (SHAPE_ROWS_SHIFT, SHAPE_ROWS_REAL):
        kt = kernel_times(qf, shape, dev, rows=True)
        rows_times[shape] = (kt["quadform_device_ms"], kt["quadform_plain_device_ms"],
                             *quadform_bound_ms(*shape, per_trial=True))
        emit("timing_rows", card=smi, bound_ms=rows_times[shape][2],
             bound_by=rows_times[shape][3], **kt)

    by_phase_new = {"io": wl_io, "workloads_sim": wl_sim, "workloads_2d": wl_2d}
    new_rows = [(f"Neuropixels twin's fit, {shape[2]} trials kept", shape)
                for shape in npx_shapes(merge_counts(wl_2d, wl_io))]
    new_rows += [("sim_from_gp_1d twin's fit", SHAPE_SIM1D),
                 ("mismatch study's fits and SMC", SHAPE_MISMATCH),
                 ("sim_from_gp_2d twin's fit", SHAPE_SIM2D),
                 ("simple template's fits", SHAPE_TEMPLATE)]
    for label, shape in new_rows:
        check(sum(d.get(shape, 0) for d in by_phase_new.values()) > 0,
              f"the {label} {shape} launched no kernel")
    gen = torch.Generator().manual_seed(0)
    new_times = {}
    for _, shape in new_rows:
        if shape not in abs_err:
            abs_err[shape] = check_kernel(qf, shape, dev, gen)
        kt = kernel_times(qf, shape, dev)
        new_times[shape] = (kt["quadform_device_ms"], kt["quadform_plain_device_ms"],
                            *quadform_bound_ms(*shape))
        emit("timing_new_shapes", **kt)

    abs_err[SHAPE_SHARDED] = check_kernel(qf, SHAPE_SHARDED, dev, gen)
    kt = kernel_times(qf, SHAPE_SHARDED, dev)
    emit("timing_sharded", **kt)
    new_times[SHAPE_SHARDED] = (kt["quadform_device_ms"], kt["quadform_plain_device_ms"],
                                *quadform_bound_ms(*SHAPE_SHARDED))

    emit("eigh_jacobi_launches", launches=merge_counts(*ej_by_phase.values()),
         launches_by_phase=ej_by_phase)
    bound_ms, bound_by = quadform_bound_ms(*SHAPE_1D)
    print(smi)
    # one kernel at the two shapes its main paths give it.  library_ms: no
    # single PyTorch call computes the whitened, weighted sum of squares (the
    # plain version is two matmuls, a multiply and a sum)
    common = {"route": "cuda", "source": "gpcsd_tpu_torch/csrc/quadform.cu",
              "replaces": "gpcsd_tpu/ops/pallas/quadform.py:32", "library_ms": None}
    print(json.dumps({"kernels": [
        {"name": "quadform", "shape": list(SHAPE_1D), **common,
         "launches": sum(launches_by_phase.values()), "launches_by_phase": launches_by_phase,
         "max_abs_err": abs_err[SHAPE_1D], "ms": device_ms, "plain_ms": plain_device_ms,
         "bound_ms": bound_ms, "bound_by": bound_by},
        {"name": "quadform at the 2D shape", "shape": list(SHAPE_2D), **common,
         "launches": sum(launches_2d.values()), "launches_by_phase": launches_2d,
         "max_abs_err": abs_err[SHAPE_2D], "ms": timing_2d["quadform_device_ms"],
         "plain_ms": timing_2d["quadform_plain_device_ms"],
         "bound_ms": timing_2d["quadform_bound_ms"], "bound_by": timing_2d["quadform_bound_by"]},
        *({"name": f"quadform at the {label}", "shape": list(shape), **common,
           "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
           "max_abs_err": abs_err[shape], "ms": analysis[shape][0], "plain_ms": analysis[shape][1],
           "bound_ms": analysis[shape][2], "bound_by": analysis[shape][3]}
          for label, shape, by_phase in (
              ("auditory twin's fit", SHAPE_AUD, {"workloads": wl.get(SHAPE_AUD, 0),
                                                  "io": wl_io.get(SHAPE_AUD, 0)}),
              ("evoked twin's fit", SHAPE_FMF, {"shifts": fit_fmf, "workloads": wl.get(SHAPE_FMF, 0)}))),
        # the per-trial output of the same kernel: one launch per batched
        # evaluation of the shift stage, at (nx, nt, B) for the B trials
        # evaluated; the shape given is the first evaluation's (all trials)
        *({"name": f"quadform_rows at the {label}", "shape": list(shape), **common,
           "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
           "max_abs_err": rows_err[shape], "ms": rows_times[shape][0], "plain_ms": rows_times[shape][1],
           "bound_ms": rows_times[shape][2], "bound_by": rows_times[shape][3]}
          for label, shape, by_phase in (
              ("shift stage", SHAPE_ROWS_SHIFT, rows_shifts),
              ("real-data evoked twin's shift stage", SHAPE_ROWS_REAL, {"io": rows_real}))),
        *({"name": f"quadform at the {label}", "shape": list(shape), **common,
           "launches": sum(d.get(shape, 0) for d in by_phase_new.values()),
           "launches_by_phase": {k: d.get(shape, 0) for k, d in by_phase_new.items() if d.get(shape, 0)},
           "max_abs_err": abs_err[shape], "ms": new_times[shape][0], "plain_ms": new_times[shape][1],
           "bound_ms": new_times[shape][2], "bound_by": new_times[shape][3]}
          for label, shape in new_rows),
        # no TPU kernel: the temporal eigh, against the per-row cuSOLVER loop it replaces
        # (launches: every launch at the row's order n, any row count, by phase)
        *({"name": "eigh_jacobi", "shape": [r["rows"], r["n"]], "route": "cuda",
           "source": "gpcsd_tpu_torch/csrc/eigh_jacobi.cu", "replaces": None,
           "library_ms": r["library_ms"], "ms": r["ms"], "eager_ms": r["eager_ms"],
           "bound_ms": r["bound_ms"], "bound_by": "operations", "cluster": r["cluster"],
           "sweeps_per_row": r["sweeps_per_row"],
           "launches": sum(d.get(r["n"], 0) for d in ej_by_phase.values()),
           "launches_by_phase": {ph: d[r["n"]] for ph, d in ej_by_phase.items() if d.get(r["n"], 0)}}
          for r in eigh_rows),
        {"name": "quadform at the trial-sharded block", "shape": list(SHAPE_SHARDED), **common,
         "launches": sum(par_sharded.values()), "launches_by_phase": par_sharded,
         "max_abs_err": abs_err[SHAPE_SHARDED], "ms": new_times[SHAPE_SHARDED][0],
         "plain_ms": new_times[SHAPE_SHARDED][1], "bound_ms": new_times[SHAPE_SHARDED][2],
         "bound_by": new_times[SHAPE_SHARDED][3]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
