"""PyTorch port on the card: the quadform CUDA kernel (scalar and per-trial),
the batched block-Jacobi eigensolver of the temporal factor, the log-joint
(single and batched, 1D and 2D), ``predict``, ``sample_posterior``, the batched
L-BFGS ``fit``, and the analysis stages (``signal``, ``torus_graph_fit`` and
its bootstrap, ``estimate_shifts``) on CUDA, against their plain versions
and the CPU; the program's host-sync counters against the syncs CUDA
reports, and its spans over the kernels they hold.

Every test here needs an NVIDIA GPU and nvcc and skips without them.  The
card has no JAX and ``tests/conftest.py`` imports it, so run this file
there without the conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from gpcsd_tpu_torch import GPCSD1D, HalfNormal
from gpcsd_tpu_torch.ops.cuda import quadform as qf

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")


@pytest.fixture(autouse=True)
def _needs_card():
    _card()


def inputs(seed, nx, nt, ntrials):
    rng = np.random.default_rng(seed)
    qs = np.linalg.qr(rng.normal(size=(nx, nx)))[0]
    qt = np.linalg.qr(rng.normal(size=(nt, nt)))[0]
    dinv = rng.uniform(0.5, 2.0, size=(nx, nt))
    Y = rng.normal(size=(ntrials, nx, nt))
    return [torch.tensor(a, dtype=torch.float64, device="cuda") for a in (qs, qt, dinv, Y)]


@pytest.mark.parametrize("shape", [
    (24, 600, 100), (7, 129, 3), (69, 375, 5),
    # the Neuropixels 2D shape: odd nt (Qt copied to an even row stride),
    # nx not a multiple of the row tile, 16-row fragments straddling trials
    (69, 375, 100),
    # edges of the kernel's tiling: one trial (less than one row tile),
    # ragged k and j edges, a trial over several row tiles, nx = 811, 1 x 8
    (24, 600, 1), (24, 601, 7), (130, 64, 2), (811, 16, 1), (1, 8, 1),
])
def test_kernel_matches_reference(shape):
    """f64 with another summation order: value rtol 1e-12, gradients 1e-10;
    two calls give the same bits (fixed-order reduction)."""
    ins = inputs(9, *shape)
    before = qf.launch_count
    got = qf.quadform_cuda(*ins)
    assert qf.launch_count == before + 1
    want = qf.quadform_reference(*ins)
    assert np.isclose(float(got), float(want), rtol=1e-12, atol=0.0)
    assert float(qf.quadform_cuda(*ins)) == float(got)  # fixed-order reduction
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    ga = torch.autograd.grad(qf.quadform(*a), a[:3])
    gb = torch.autograd.grad(qf.quadform_reference(*b), b[:3])
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-10 * float(y.abs().max()))


@pytest.mark.parametrize("shape", [
    # small; an odd nt with trials straddling the 64-row tiles (the real-data
    # shift stage's width); one trial; the shift stages' batches
    (5, 7, 3), (24, 151, 7), (3, 10, 1), (24, 60, 40), (24, 151, 60),
])
def test_rows_kernel_matches_reference(shape):
    """The per-trial output: every trial within 1e-12 of its plain version,
    the sum within 1e-13 of the scalar kernel, two calls the same bits,
    gradients as the plain version's; counted apart from the scalar kernel."""
    ins = inputs(11, *shape)
    before, rows_before = qf.launch_count, qf.rows_launch_count
    got = qf.quadform_rows_cuda(*ins)
    assert (qf.launch_count, qf.rows_launch_count) == (before, rows_before + 1)
    want = qf.quadform_rows_reference(*ins)
    assert got.shape == (shape[2],)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0.0)
    assert torch.equal(qf.quadform_rows_cuda(*ins), got)  # fixed-order reduction
    total = float(qf.quadform_cuda(*ins))
    assert abs(float(got.sum()) - total) <= 1e-13 * abs(total)
    w = torch.linspace(-1.0, 2.0, shape[2], dtype=torch.float64, device="cuda")
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    ga = torch.autograd.grad((qf.quadform_rows(*a) * w).sum(), a)
    gb = torch.autograd.grad((qf.quadform_rows_reference(*b) * w).sum(), b)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-10 * float(y.abs().max()))


def test_kernel_takes_unaligned_qt():
    """A Qt that is contiguous but only 8-byte aligned cannot back a tensor
    map: the kernel copies it to an aligned scratch first."""
    qs, qt, dinv, Y = inputs(4, 24, 64, 3)
    storage = torch.empty(qt.numel() + 1, dtype=torch.float64, device="cuda")
    qt_off = storage[1:].view(qt.shape).copy_(qt)
    assert qt_off.data_ptr() % 16 == 8 and qt_off.is_contiguous()
    got = float(qf.quadform_cuda(qs, qt_off, dinv, Y))
    assert np.isclose(got, float(qf.quadform_reference(qs, qt, dinv, Y)), rtol=1e-12, atol=0.0)


def test_wrapper_rejects_mixed_devices():
    qs, qt, dinv, Y = inputs(1, 4, 9, 2)
    with pytest.raises(ValueError, match="device|cuda"):
        qf.quadform(qs.cpu(), qt, dinv, Y)


def test_log_prob_cuda_matches_cpu():
    """A small per-channel-noise model at well-conditioned values (two
    LAPACK builds agree here to 8e-12 on the value and 2e-10 in norm on
    the gradient): CUDA vs CPU f64, value rtol 1e-10 and gradient 1e-8 in
    norm, through the kernel."""
    rng = np.random.default_rng(2)
    x = (np.arange(10) * 100.0).reshape(-1, 1)
    t = np.arange(40.0).reshape(-1, 1)
    lfp = rng.normal(size=(10, 40, 6))
    kw = dict(ngl=40, sig2n_prior=[HalfNormal(0.1) for _ in range(10)], het_noise="exact")
    m_gpu = GPCSD1D(lfp, x, t, device="cuda", **kw)
    m_cpu = GPCSD1D(lfp, x, t, device="cpu", **kw)
    for m in (m_gpu, m_cpu):
        m.R["value"] = 120.0
        m.spatial_cov.params["ell"]["value"] = 180.0
        m.temporal_cov_list[0].params["ell"]["value"] = 5.0
        m.temporal_cov_list[1].params["ell"]["value"] = 2.0
    u = m_cpu._fns().param_set.pack(m_cpu._theta()).numpy()
    out = []
    before = qf.launch_count
    for m in (m_gpu, m_cpu):
        ut = torch.tensor(u, device=m.device, requires_grad=True)
        lp = m._fns().log_prob(ut, m._Y())
        (g,) = torch.autograd.grad(lp, ut)
        out.append((float(lp.detach()), g.cpu().numpy()))
    assert qf.launch_count == before + 1
    assert np.isclose(out[0][0], out[1][0], rtol=1e-10)
    assert np.linalg.norm(out[0][1] - out[1][1]) <= 1e-8 * np.linalg.norm(out[1][1])


def small_models():
    """The same small per-channel-noise model on the card and on the CPU."""
    rng = np.random.default_rng(2)
    x = (np.arange(10) * 100.0).reshape(-1, 1)
    t = np.arange(40.0).reshape(-1, 1)
    lfp = rng.normal(size=(10, 40, 6))
    kw = dict(ngl=40, sig2n_prior=[HalfNormal(0.1) for _ in range(10)], het_noise="exact")
    models = [GPCSD1D(lfp, x, t, **kw), GPCSD1D(lfp, x, t, device="cpu", **kw)]
    for m in models:
        m.R["value"] = 120.0
        m.spatial_cov.params["ell"]["value"] = 180.0
        m.temporal_cov_list[0].params["ell"]["value"] = 5.0
        m.temporal_cov_list[1].params["ell"]["value"] = 2.0
    return models


def test_default_device_is_the_card():
    m_gpu, _ = small_models()
    assert m_gpu.device.type == "cuda" and m_gpu._Y().is_cuda
    from gpcsd_tpu_torch.infer import dense_metric, hmc, nuts
    assert hmc.welford_init(3).mean.is_cuda
    assert dense_metric.dense_welford_init(3).m2.is_cuda
    assert nuts.draw_noise(nuts.chain_generators(0, 1), 3, 2).xi.is_cuda


def test_batched_log_prob_matches_unbatched_on_cuda():
    """Rows of a (C, dim) batch against C single calls on the card: value
    rtol 1e-12, gradient 1e-10 in norm (batched cuSOLVER and cuBLAS calls
    may sum in another order), one kernel launch per row."""
    from gpcsd_tpu_torch.models.core import value_and_grad_rows

    m, _ = small_models()
    fns, Y = m._fns(), m._Y()
    u0 = fns.param_set.pack(m._theta())
    us = u0[None] + 0.05 * torch.tensor(np.random.default_rng(0).normal(size=(4, u0.numel())),
                                         device="cuda")
    before = qf.launch_count
    vals, grads = value_and_grad_rows(lambda u: fns.log_prob(u, Y), us)
    assert qf.launch_count == before + 4
    for u, v, g in zip(us, vals, grads):
        ui = u.clone().requires_grad_()
        f = fns.log_prob(ui, Y)
        (gi,) = torch.autograd.grad(f, ui)
        assert np.isclose(float(v), float(f.detach()), rtol=1e-12, atol=0.0)
        assert float((g - gi).norm()) <= 1e-10 * float(gi.norm())


def test_predict_cuda_matches_cpu():
    """CSD and LFP predictions, totals and components, card vs CPU: 1e-9
    in the max norm (two eigensolvers behind the same factored solve)."""
    m_gpu, m_cpu = small_models()
    z, ts = np.linspace(0.0, 900.0, 19), np.arange(0.0, 40.0, 3.0)
    for m in (m_gpu, m_cpu):
        m.predict(z, ts, type="both")
    for name in ("csd_pred", "lfp_pred"):
        got, want = getattr(m_gpu, name), getattr(m_cpu, name)
        assert got.shape == (19, ts.size, 6)
        assert np.max(np.abs(got - want)) <= 1e-9 * np.max(np.abs(want))
        for a, b in zip(getattr(m_gpu, name + "_list"), getattr(m_cpu, name + "_list")):
            assert np.max(np.abs(a - b)) <= 1e-9 * np.max(np.abs(want))


def test_sample_posterior_launches_the_kernel():
    """4 x (20 + 20) transitions on the card: finite draws, and at least
    one quadform launch per leapfrog step the sampler counted."""
    m, _ = small_models()
    before = qf.launch_count
    post = m.sample_posterior(n_chains=4, num_warmup=20, num_samples=20, seed=0, max_depth=5,
                              dense_mass=True)
    launches = qf.launch_count - before
    assert launches > 0 and launches >= int(post.diagnostics["num_steps"].sum())
    assert post.raw.samples.is_cuda and post.raw.samples.shape == (4, 20, 16)
    assert all(np.isfinite(v).all() for v in post.theta.values())
    assert (post.diagnostics["step_size"] > 1e-3).all()


def small_models_2d():
    """The Neuropixels geometry at a small size (nt=24, 4 trials, an 8 x 20
    rule), on the card and on the CPU."""
    from gpcsd_tpu_torch import paper

    kw = dict(seed=3, nt=24, ntrials=4, ngl1=8, ngl2=20)
    return paper.neuropixels_problem(**kw), paper.neuropixels_problem(device="cpu", **kw)


def test_log_prob_2d_cuda_matches_cpu():
    """GPCSD2D log_prob on the card against the CPU, through the kernel.
    The 69 x 69 quadrature Gram has norm ~1e9 and eigenvalues down at the
    noise variance, where the two eigensolvers' errors (1e-16 of the norm)
    weigh ~1e-5 of the noise: value rtol 1e-4, gradient 2e-3 in norm (an
    H100 reads 1.6e-5 and 2.3e-4 here, 1.4e-5 and 1.6e-4 at the full shape)."""
    m_gpu, m_cpu = small_models_2d()
    u = m_cpu._fns().param_set.pack(m_cpu._theta()).numpy()
    out = []
    before = qf.launch_count
    for m in (m_gpu, m_cpu):
        ut = torch.tensor(u, device=m.device, requires_grad=True)
        lp = m._fns().log_prob(ut, m._Y())
        (g,) = torch.autograd.grad(lp, ut)
        out.append((float(lp.detach()), g.cpu().numpy()))
    assert qf.launch_count == before + 1
    assert np.isfinite(out[0][0]) and np.all(np.isfinite(out[0][1]))
    value_err = abs(out[0][0] - out[1][0]) / abs(out[1][0])
    grad_err = np.linalg.norm(out[0][1] - out[1][1]) / np.linalg.norm(out[1][1])
    print(f"2D log_prob card vs CPU: value {value_err:.3e}, gradient {grad_err:.3e}")
    assert value_err <= 1e-4 and grad_err <= 2e-3


def test_fit_torch_backend_launches_the_kernel():
    """``fit(backend="torch")`` on the card: one kernel launch per row the
    optimizer evaluated, every restart finite and no higher than its start."""
    from gpcsd_tpu_torch.infer.map import sample_restarts

    m, _ = small_models_2d()
    fns, Y = m._fns(), m._Y()
    u0s = torch.tensor(sample_restarts(fns.param_set, np.random.default_rng(0), 3), device="cuda")
    with torch.no_grad():
        nll0 = fns.neg_log_joint(u0s, Y).cpu().numpy()
    before = qf.launch_count
    res = m.fit(n_restarts=3, seed=0, options={"maxiter": 5})
    assert qf.launch_count - before == int(res.n_evals.sum()) > 0
    assert np.all(np.isfinite(res.nll_values)) and np.all(res.nll_values <= nll0)


# ---- the analysis stages: card vs CPU


def test_signal_cuda_matches_cpu():
    from gpcsd_tpu_torch import signal as tsig

    x = np.random.default_rng(0).normal(size=(60, 24, 199)).cumsum(axis=-1)
    filt = tsig.bandpass_filtfilt(x, 8.0, 12.0, 1000.0, device="cuda")
    want = tsig.bandpass_filtfilt(x, 8.0, 12.0, 1000.0, device="cpu")
    assert filt.device.type == "cuda"
    assert float((filt.cpu() - want).abs().max() / want.abs().max()) <= 1e-12
    ph = tsig.instantaneous_phase(filt, device="cuda").cpu().numpy()
    ph_cpu = tsig.instantaneous_phase(want, device="cpu").numpy()
    assert np.abs(np.exp(1j * ph) - np.exp(1j * ph_cpu)).max() <= 1e-9
    _, p = tsig.periodogram(x, fs=1000.0, device="cuda")
    _, p_cpu = tsig.periodogram(x, fs=1000.0, device="cpu")
    assert float((p.cpu() - p_cpu).abs().max() / p_cpu.abs().max()) <= 1e-12


def test_torus_graph_fit_cuda_matches_cpu():
    from gpcsd_tpu_torch.models import torus_graph as tg

    lay = tg.layout(6)
    phi = np.zeros(lay.m)
    phi[lay.diff_off] = phi[lay.diff_off + 5] = 1.0
    X = tg.gibbs_sample(phi, 6, 2000, seed=3)
    got, want = tg.torus_graph_fit(X, device="cuda"), tg.torus_graph_fit(X, device="cpu")
    for f in ("phi", "phi_cov", "pvals", "kappa", "cond_coupling"):
        a, b = getattr(got, f).cpu(), getattr(want, f)
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-9, f
    idx = torch.randint(0, 2000, (6, 2000), generator=torch.Generator().manual_seed(1))
    bs = tg.bootstrap_partial_plv(X, 6, indices=idx, batch_size=4, device="cuda").cpu()
    bs_cpu = tg.bootstrap_partial_plv(X, 6, indices=idx, batch_size=4, device="cpu")
    assert float((bs - bs_cpu).abs().max()) <= 1e-9


def test_estimate_shifts_cuda_matches_cpu(monkeypatch):
    """Card vs CPU; each batched evaluation of the trials is one launch of
    the per-trial kernel and none of the scalar one."""
    from gpcsd_tpu_torch.models import shifts
    from gpcsd_tpu_torch.models.shifts import estimate_shifts

    calls = []
    shift_nll = shifts.shift_nll
    monkeypatch.setattr(shifts, "shift_nll", lambda *a: calls.append(1) or shift_nll(*a))
    gpu, cpu = small_models()
    with torch.no_grad():
        fg, fc = gpu._fns().build_factors(gpu._theta()), cpu._fns().build_factors(cpu._theta())
    rng = np.random.default_rng(2)
    lfp = rng.normal(size=gpu.lfp.shape)
    nx, nt = lfp.shape[:2]
    mu = np.sin(np.linspace(0, 3, nt))[None, None, :] * np.linspace(-1, 1, nx)[None, :, None]
    before, rows_before = qf.launch_count, qf.rows_launch_count
    rg = estimate_shifts(lfp, np.zeros((nx, nt)), mu, np.arange(nt) * 1.0, fg, maxiter=30, device="cuda")
    assert qf.launch_count == before
    assert qf.rows_launch_count - rows_before == len(calls) > 0
    rc = estimate_shifts(lfp, np.zeros((nx, nt)), mu, np.arange(nt) * 1.0, fc, maxiter=30, device="cpu")
    assert np.abs(rg.tau - rc.tau).max() <= 1e-6
    assert np.array_equal(rg.converged, rc.converged)


# ---- the program's host-sync counters and spans on the card


def sync_windows(run):
    """Call ``run(mark)`` under ``torch.cuda.set_sync_debug_mode("warn")``,
    where ``run`` calls ``mark()`` at the boundaries of the windows to
    compare.  Returns, per window between two marks, (the syncs CUDA
    reported, the change of the program's ``host_sync.*`` counters)."""
    import warnings

    from gpcsd_tpu_torch.utils import profiling

    marks = []
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(lambda: marks.append(
                (sum("synchroniz" in str(w.message) for w in ws), profiling.counters())))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    out = []
    for (n0, c0), (n1, c1) in zip(marks[:-1], marks[1:]):
        counted = sum(v - c0.get(k, 0) for k, v in c1.items() if k.startswith("host_sync."))
        out.append((n1 - n0, counted))
    return out


@pytest.mark.parametrize("models", [small_models, small_models_2d], ids=["1d", "2d"])
def test_host_sync_counters_match_cuda_over_transitions(models):
    """Over each NUTS transition (warm-up with the step-size guard, and
    sampling), the syncs ``set_sync_debug_mode`` reports equal the change of
    the program's ``host_sync.*`` counters."""
    m = models()[0]
    windows = sync_windows(lambda mark: m.sample_posterior(
        n_chains=4, num_warmup=4, num_samples=3, seed=7, max_depth=4,
        callback=lambda i, carry: mark()))
    assert len(windows) == 6
    for reported, counted in windows:
        assert reported == counted > 0


def test_host_sync_counters_match_cuda_over_lbfgs_iterations(monkeypatch):
    """Over each L-BFGS iteration (from one two-loop recursion to the next),
    the syncs ``set_sync_debug_mode`` reports equal the change of the
    program's ``host_sync.*`` counters."""
    from gpcsd_tpu_torch.infer import lbfgs

    m = small_models()[0]
    two_loop = lbfgs._two_loop
    marker = {}

    def marked(*args):
        marker["mark"]()
        return two_loop(*args)

    monkeypatch.setattr(lbfgs, "_two_loop", marked)

    def run(mark):
        marker["mark"] = mark
        m.fit(n_restarts=3, seed=0, options={"maxiter": 6})

    windows = sync_windows(run)
    assert len(windows) >= 3
    for reported, counted in windows:
        assert reported == counted > 0


def test_profiled_transition_puts_the_kernels_under_their_spans():
    """One profiled transition at the auditory shape (the benchmark's slice
    reduction): the device time under ``gpcsd.kronlik.quad_term`` holds the
    quadform kernels' own (and not twice it), and the time under
    ``gpcsd.kronlik.comp_eig_d`` the forward ``eigh``s'."""
    import os

    from benchmark.trace import Slice
    from gpcsd_tpu_torch import paper
    from torch.autograd import DeviceType

    dev = torch.device("cuda")
    lfp, time_ms, _ = paper.paper_surrogate(0, 1200, 100, device=dev)
    m = paper.build_model(lfp, time_ms, het_noise="exact", device=dev)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    banked = np.load(os.path.join(root, "results", "paper_nuts_hetx", "posterior_samples.npz"))
    fns = m._fns()
    u = torch.tensor(banked["raw_u"].reshape(-1, 30).mean(axis=0), device=dev)
    m._set_theta(fns.full_theta(fns.param_set.unpack(u)))
    sl = Slice(dev)

    def callback(i, carry):
        if i == 2:
            sl.start()
        elif i == 3:
            sl.stop()

    m.sample_posterior(n_chains=4, num_warmup=3, num_samples=1, seed=3, max_depth=3,
                       callback=callback)
    s = sl.summary()
    kernels = sum(e.time_range.elapsed_us() * 1e-6 for e in sl.done.events()
                  if e.device_type == DeviceType.CUDA and any(
                      k in e.name for k in ("whiten_rows_kernel", "quadform_gemm_kernel",
                                            "sum_partials_kernel")))
    quad = s["op_device_s"]["gpcsd.kronlik.quad_term"]
    factor = s["op_device_s"]["gpcsd.kronlik.comp_eig_d"]
    print(f"quad_term {quad:.6f} s over its kernels {kernels:.6f} s; comp_eig_d {factor:.6f} s "
          f"over aten::linalg_eigh {s['op_device_s']['aten::linalg_eigh']:.6f} s")
    assert 0 < kernels <= quad <= 2 * kernels
    assert factor >= s["op_device_s"]["aten::linalg_eigh"] > 0


# ---- the log-joint pass through CUDA graphs

#: gradient of a pass through the halves (eager or replayed) against the plain
#: log-joint's, relative in the 2-norm: each half returns u's gradient summed
#: inside it, where the plain backward adds u's partial gradients in another
#: order (the CPU reads ~2e-16 for the same two orders)
GRAPH_GRAD_RTOL = 1e-12


@pytest.fixture(scope="module")
def auditory():
    """The paper's auditory model (24 sites, 600 samples, 100 trials, exact
    per-channel noise: 30 parameters) at the banked posterior's mean."""
    import os

    _card()

    from gpcsd_tpu_torch import paper

    dev = torch.device("cuda")
    lfp, time_ms, _ = paper.paper_surrogate(0, 1200, 100, device=dev)
    m = paper.build_model(lfp, time_ms, het_noise="exact", device=dev)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    banked = np.load(os.path.join(root, "results", "paper_nuts_hetx", "posterior_samples.npz"))
    fns = m._fns()
    u = torch.tensor(banked["raw_u"].reshape(-1, 30).mean(axis=0), device=dev)
    m._set_theta(fns.full_theta(fns.param_set.unpack(u)))
    return m


@pytest.fixture(scope="module")
def neuropixels():
    """The Neuropixels model (69 sites, 375 samples, 100 trials, a 30 x 120
    rule, scalar noise: 8 parameters) at its fixed point."""
    from gpcsd_tpu_torch import paper

    _card()

    return paper.neuropixels_problem(device="cuda")


def fresh_fns(m):
    """The model's functions built anew: no graph captured, no key seen."""
    m._fns_cache.clear()
    return m._fns()


def graph_counts():
    from gpcsd_tpu_torch.utils import profiling

    c = profiling.counters()
    return np.array([c.get(f"graph.{k}", 0) for k in ("eager", "capture", "replay")])


def rows_near(m, fns, rows, seed, scale=0.05):
    u0 = fns.param_set.pack(m._theta()).to("cuda")
    return u0 + scale * torch.tensor(np.random.default_rng(seed).normal(size=(rows, u0.numel())),
                                     device="cuda")


def eager_value_and_grad(fn, u):
    """The value and gradient of ``fn`` by plain autograd, outside a pass."""
    u = u.clone().requires_grad_()
    f = fn(u)
    (g,) = torch.autograd.grad(f.sum(), u)
    return f.detach(), g


@pytest.mark.parametrize("which,objective,row_counts", [
    ("auditory", "log_prob", (1, 3, 4)),
    ("neuropixels", "log_prob", (1, 3, 4)),
    ("auditory", "neg_log_joint", tuple(range(1, 11))),
])
def test_graphed_pass_matches_eager(request, which, objective, row_counts):
    """At each row count three passes at distinct points: the first runs
    eagerly, the second captures, the third replays.  Each pass's values
    equal the plain log-joint's bit for bit and its gradient agrees to
    GRAPH_GRAD_RTOL in norm; a later pass leaves an earlier one's results
    as they were (they are copies, not the graph's buffers); and a fourth
    pass, replayed at the first one's rows, gives that eager pass's values
    and gradients bit for bit."""
    from gpcsd_tpu_torch.models.core import value_and_grad_rows

    m = request.getfixturevalue(which)
    fns, Y = fresh_fns(m), m._Y()
    fn = lambda u: getattr(fns, objective)(u, Y)  # noqa: E731
    worst = 0.0
    for rows in row_counts:
        points = [rows_near(m, fns, rows, seed=10 * rows + k) for k in range(3)]
        before = graph_counts()
        results, kept = [], []
        for u in points:
            v, g = value_and_grad_rows(fn, u)
            results.append((v, g))
            kept.append((v.clone(), g.clone()))
        v, g = value_and_grad_rows(fn, points[0])
        assert torch.equal(v, kept[0][0]) and torch.equal(g, kept[0][1])
        assert list(graph_counts() - before) == [1, 1, 3]
        for u, (v, g), (kv, kg) in zip(points, results, kept):
            assert torch.equal(v, kv) and torch.equal(g, kg)
            ve, ge = eager_value_and_grad(fn, u)
            assert torch.equal(v, ve)
            err = float((g - ge).norm() / ge.norm())
            worst = max(worst, err)
            assert err <= GRAPH_GRAD_RTOL, (rows, err)
    print(f"{which} {objective}: graphed gradient against eager, worst {worst:.3e}")


def test_a_key_seen_once_stays_eager(auditory):
    """A row count seen once runs eagerly and captures nothing; the second
    pass at it captures."""
    from gpcsd_tpu_torch.models.core import value_and_grad_rows

    fns, Y = fresh_fns(auditory), auditory._Y()
    fn = lambda u: fns.log_prob(u, Y)  # noqa: E731
    before = graph_counts()
    value_and_grad_rows(fn, rows_near(auditory, fns, 5, seed=1))
    value_and_grad_rows(fn, rows_near(auditory, fns, 6, seed=2))
    assert list(graph_counts() - before) == [2, 0, 0] and len(fns.graphs) == 2
    value_and_grad_rows(fn, rows_near(auditory, fns, 5, seed=3))
    assert list(graph_counts() - before) == [2, 1, 1]


def test_graphed_pass_keeps_a_non_finite_row_to_itself(auditory):
    """A row whose temporal Gram is not finite (its SE variance overflows)
    gives a non-finite density in a replayed pass, as eagerly, and the other
    rows' values and gradients are the eager pass's."""
    from gpcsd_tpu_torch.models.core import value_and_grad_rows

    fns, Y = fresh_fns(auditory), auditory._Y()
    fn = lambda u: fns.log_prob(u, Y)  # noqa: E731
    for seed in (1, 2):
        value_and_grad_rows(fn, rows_near(auditory, fns, 4, seed=seed))
    u = rows_near(auditory, fns, 4, seed=3)
    u[2, fns.param_set.names_flat().index("tm0_sigma2")] = 800.0
    before = graph_counts()
    v, g = value_and_grad_rows(fn, u)
    assert list(graph_counts() - before) == [0, 0, 1]
    ve, ge = eager_value_and_grad(fn, u)
    finite = torch.isfinite(v)
    assert finite.tolist() == [True, True, False, True] == torch.isfinite(ve).tolist()
    assert torch.equal(v[finite], ve[finite])
    assert torch.isfinite(g[finite]).all()
    assert float((g[finite] - ge[finite]).norm() / ge[finite].norm()) <= GRAPH_GRAD_RTOL


def test_host_sync_counters_match_cuda_over_graphed_passes(auditory):
    """Over each pass at one row count (eager, capture, replays), the syncs
    ``set_sync_debug_mode`` reports equal the change of the program's
    ``host_sync.*`` counters; a replayed pass syncs only in its spatial
    ``eigh`` (the temporal one is the block-Jacobi kernel, which reads
    nothing back)."""
    from gpcsd_tpu_torch.models.core import value_and_grad_rows

    fns, Y = fresh_fns(auditory), auditory._Y()
    points = [rows_near(auditory, fns, 4, seed=s) for s in range(4)]

    def run(mark):
        mark()
        for u in points:
            value_and_grad_rows(lambda x: fns.log_prob(x, Y), u)
            mark()

    before = graph_counts()
    windows = sync_windows(run)
    assert list(graph_counts() - before) == [1, 1, 3]
    assert [counted for _, counted in windows] == [1, 1, 1, 1]
    for reported, counted in windows:
        assert reported == counted


def test_resumed_fit_repeats_the_uninterrupted_one_through_graphs(auditory):
    """A fit stopped at every checkpoint and rerun gives the uninterrupted
    fit bit for bit although their passes meet the graphs' cache in another
    state (eager first sightings in one, replays in the other): a pass gives
    the same bits eager and replayed, at the optimizer's restart points too."""
    import os
    import shutil
    import tempfile

    from gpcsd_tpu_torch.infer.lbfgs import LBFGSTimeBudget

    fresh_fns(auditory)
    before = graph_counts()
    whole = auditory.fit(n_restarts=3, seed=0, options={"maxiter": 12})
    tmp = tempfile.mkdtemp(prefix="resume_")
    opts = {"maxiter": 12, "chunk_iters": 3, "max_wall_seconds": 0,
            "state_path": os.path.join(tmp, "map_state")}
    try:
        for _ in range(12):
            try:
                res = auditory.fit(n_restarts=3, seed=0, options=opts)
                break
            except LBFGSTimeBudget:
                pass
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    eager, capture, replay = graph_counts() - before
    assert eager > 0 and capture > 0 and replay > eager
    assert np.array_equal(res.u_all, whole.u_all)
    assert np.array_equal(res.nll_values, whole.nll_values)
    assert np.array_equal(res.n_evals, whole.n_evals)


def test_graphs_of_many_row_counts_share_their_memory(neuropixels):
    """Six row counts of the Neuropixels objective captured from the largest
    down (as an optimizer's restarts drop out): the card memory the graphs
    keep (reserved after ``empty_cache``, so the eager cache is not counted)
    stays within twice one eager pass's working set at the largest, where a
    pool a key would keep the sum over the keys.  Captured from the smallest
    up, each capture needs larger blocks than the ones freed before it, and
    the shared pool keeps up to that sum (within a quarter, for the
    allocator's rounding), but not more."""
    from gpcsd_tpu_torch.models.core import value_and_grad_rows

    Y = neuropixels._Y()
    working_sets = {}
    for rows in range(1, 7):
        fns = fresh_fns(neuropixels)
        fn = lambda u: fns.neg_log_joint(u, Y)  # noqa: E731
        torch.cuda.synchronize()
        allocated0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eager_value_and_grad(fn, rows_near(neuropixels, fns, rows, seed=0))
        working_sets[rows] = torch.cuda.max_memory_allocated() - allocated0
    kept = {}
    for order in (range(6, 0, -1), range(1, 7)):
        fns = fresh_fns(neuropixels)
        fn = lambda u: fns.neg_log_joint(u, Y)  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        before = graph_counts()
        for rows in order:
            for k in range(3):
                value_and_grad_rows(fn, rows_near(neuropixels, fns, rows, seed=10 * rows + k))
        assert list(graph_counts() - before) == [6, 6, 12]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        kept[order.start] = torch.cuda.memory_reserved() - reserved0
    total = sum(working_sets.values())
    print(f"graphs of 6 row counts keep {kept[6] / 1e9:.3f} GB captured downward, "
          f"{kept[1] / 1e9:.3f} GB upward; eager working sets {working_sets[6] / 1e9:.3f} GB "
          f"at 6 rows, {total / 1e9:.3f} GB summed over 1-6")
    assert kept[6] <= 2 * working_sets[6]
    assert kept[1] <= 1.25 * total


# ---- the temporal factor's batched block-Jacobi eigensolver


def prior_rows(m, rows, seed):
    """``rows`` prior draws of the model's parameters, packed (the fits'
    restarts)."""
    from gpcsd_tpu_torch.infer.map import sample_restarts

    draws = sample_restarts(m._fns().param_set, np.random.default_rng(seed), rows)
    return torch.tensor(draws, device="cuda")


def cell_kt(m, u):
    """The model's ``Kt`` at the rows ``u``, (rows, nt, nt)."""
    return m._fns().graphs.inputs_half(u)[1].detach().contiguous()


def jacobi_counts():
    from gpcsd_tpu_torch.utils import profiling

    c = profiling.counters()
    return np.array([c.get(f"kronlik.jacobi.{k}", 0) for k in ("rows", "sweeps", "unconverged")])


@pytest.mark.parametrize("which", ["auditory", "neuropixels"])
@pytest.mark.parametrize("rows", [1, 4, 10, 20])
def test_eigh_jacobi_matches_cusolver_on_the_cells_kt(request, which, rows):
    """The cells' ``Kt`` (n = 600, 375) at prior-drawn parameters: against
    ``torch.linalg.eigh``, eigenvalues within 1e-12 ||A||_F, reconstruction
    within 1e-12 ||A||_F, largest |V^T V - I| 1e-11; two calls the same
    bits; every row counted, converged, in at most ``MAX_SWEEPS`` sweeps."""
    from gpcsd_tpu_torch.ops.cuda import eigh as ej

    m = request.getfixturevalue(which)
    a = cell_kt(m, prior_rows(m, rows, seed=rows))
    before = jacobi_counts()
    w, v = ej.eigh_jacobi_cuda(a)
    w2, v2 = ej.eigh_jacobi_cuda(a)
    rows_n, sweeps, unconverged = jacobi_counts() - before
    assert torch.equal(w, w2) and torch.equal(v, v2)
    assert rows_n == 2 * rows and unconverged == 0 and 2 * rows <= sweeps <= 2 * rows * ej.MAX_SWEEPS
    norm = torch.linalg.matrix_norm(a)
    wr = torch.linalg.eigh(a)[0]
    assert torch.all((w - wr).abs().amax(-1) <= 1e-12 * norm)
    assert torch.all(torch.linalg.matrix_norm(v @ torch.diag_embed(w) @ v.mT - a) <= 1e-12 * norm)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    assert float((v.mT @ v - eye).abs().max()) <= 1e-11


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_eigh_jacobi_every_cluster_size_solves_the_batch(auditory, cluster):
    """Ten rows of the auditory ``Kt`` at prior draws (the MAP cell's first
    pass) at each cluster size: one, two or more pairs of blocks a CTA, and
    the CTA's pairs solved one after another, reusing their shared memory.
    Reconstruction within 1e-12 ||A||_F for every row."""
    from gpcsd_tpu_torch.ops.cuda import eigh as ej

    a = cell_kt(auditory, prior_rows(auditory, 10, seed=2147483713))
    w, v = ej.eigh_jacobi_cuda(a, cluster=cluster)
    norm = torch.linalg.matrix_norm(a)
    assert torch.all(torch.linalg.matrix_norm(v @ torch.diag_embed(w) @ v.mT - a) <= 1e-12 * norm)


#: Per-row relative bound on a pass's gradient, kernel against cuSOLVER:
#: the regularized backward weighs pairs of eigenvalues inside Kt's clusters
#: by their gap, which two exact solvers resolve differently at the level of
#: rounding (see the test), just above the largest per-row gap read between
#: two of the kernel, cuSOLVER and LAPACK.
KERNEL_GRAD_ROW_RTOL = 3e-6


@pytest.mark.parametrize("which,rows", [("auditory", 4), ("auditory", 10), ("neuropixels", 4)])
def test_pass_through_the_kernel_matches_the_cusolver_route(request, monkeypatch, which, rows):
    """A value+grad pass of ``neg_log_joint`` with the temporal factor from
    the kernel against the same pass with it from ``torch.linalg.eigh``
    (``JACOBI_MIN_N`` raised past n): values within 1e-10 row by row,
    gradients within :data:`KERNEL_GRAD_ROW_RTOL` row by row.  Two exact
    solvers give gradients that differ at that level: on an H100, over 48
    rows near the fixtures' points (auditory 4 and 3 x 10, Neuropixels 4 and
    10), the kernel's rows differ from cuSOLVER's by up to 2.50e-6 of their
    norm, and LAPACK's (``Kt`` factored on the CPU, the rest of the same
    pass on the card) from cuSOLVER's by up to 1.64e-6; at the four
    auditory rows LAPACK's differ from the kernel's by up to 2.72e-6."""
    from gpcsd_tpu_torch.ops import kronlik

    m = request.getfixturevalue(which)
    fns, Y = fresh_fns(m), m._Y()
    u = rows_near(m, fns, rows, seed=7)
    fn = lambda x: fns.neg_log_joint(x, Y)  # noqa: E731
    before = jacobi_counts()
    v, g = eager_value_and_grad(fn, u)
    assert (jacobi_counts() - before)[0] == rows
    monkeypatch.setattr(kronlik, "JACOBI_MIN_N", 10**9)
    vc, gc = eager_value_and_grad(fn, u)
    assert (jacobi_counts() - before)[0] == rows
    assert torch.all((v - vc).abs() <= 1e-10 * vc.abs())
    gap = (g - gc).norm(dim=1) / gc.norm(dim=1)
    assert torch.all(gap <= KERNEL_GRAD_ROW_RTOL), gap.tolist()


def test_temporal_eigh_sends_a_single_large_kt_to_cusolver(auditory):
    """One auditory ``Kt`` (n = 600, above ``JACOBI_MAX_N_ALONE``), alone or
    as a batch of one, goes to ``torch.linalg.eigh`` and counts its host
    sync; two of them, or one of order ``JACOBI_MAX_N_ALONE``, go to the
    kernel and count none."""
    from gpcsd_tpu_torch.ops import kronlik
    from gpcsd_tpu_torch.utils import profiling

    def counts():
        c = profiling.counters()
        return np.array([c.get("host_sync.kronlik.eigh", 0), c.get("kronlik.jacobi.rows", 0)])

    a = cell_kt(auditory, prior_rows(auditory, 2, seed=3))
    small = a[:1, :kronlik.JACOBI_MAX_N_ALONE, :kronlik.JACOBI_MAX_N_ALONE].contiguous()
    for x, want in ((a[0], [1, 0]), (a[:1], [1, 0]), (a, [0, 2]), (small, [0, 1])):
        before = counts()
        w, v = kronlik.temporal_eigh(x)
        assert list(counts() - before) == want
        assert w.shape == x.shape[:-1] and v.shape == x.shape
    assert torch.equal(kronlik.temporal_eigh(a[0])[0], torch.linalg.eigh(a[0])[0])


def test_temporal_eigh_makes_no_host_sync(auditory):
    """Forward and backward of the temporal factor on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing waits for the
    device (after a first call, which prepares the kernel)."""
    from gpcsd_tpu_torch.ops import kronlik

    a = cell_kt(auditory, prior_rows(auditory, 4, seed=1))
    kronlik.temporal_eigh(a)
    rng = np.random.default_rng(0)
    c = torch.tensor(rng.normal(size=a.shape[-1]), device="cuda")
    b = torch.tensor(rng.normal(size=a.shape[-2:]), device="cuda")
    x = a.clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w, v = kronlik.temporal_eigh(x)
        loss = (w * c).sum() + (c * ((v.mT @ (b + b.mT)) * v.mT).sum(-1)).sum()
        (g,) = torch.autograd.grad(loss, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(g).all()


def test_eigh_jacobi_replays_in_a_cuda_graph(auditory):
    """One launch captured in a CUDA graph: its replay gives the eager
    call's bits, for the captured input and for another copied in."""
    from gpcsd_tpu_torch.ops.cuda import eigh as ej

    a = cell_kt(auditory, prior_rows(auditory, 4, seed=2))
    a2 = cell_kt(auditory, prior_rows(auditory, 4, seed=3))
    w, v = ej.eigh_jacobi_cuda(a)
    w2, v2 = ej.eigh_jacobi_cuda(a2)
    static = a.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ej.eigh_jacobi_cuda(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        wg, vg = ej.eigh_jacobi_cuda(static)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(wg, w) and torch.equal(vg, v)
    static.copy_(a2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(wg, w2) and torch.equal(vg, v2)
