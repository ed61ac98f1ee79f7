"""PyTorch port on the card: the quadform CUDA kernel and the log-joint on
CUDA, against their plain versions and the CPU.

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


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernel)")


def inputs(seed, nx, nt, ntrials):
    rng = np.random.default_rng(seed)
    qs = np.linalg.qr(rng.normal(size=(nx, nx)))[0]
    qt = np.linalg.qr(rng.normal(size=(nt, nt)))[0]
    dinv = rng.uniform(0.5, 2.0, size=(nx, nt))
    Y = rng.normal(size=(ntrials, nx, nt))
    return [torch.tensor(a, dtype=torch.float64, device="cuda") for a in (qs, qt, dinv, Y)]


@pytest.mark.parametrize("shape", [(24, 600, 100), (7, 129, 3), (69, 375, 5)])
def test_kernel_matches_reference(shape):
    """f64 with another summation order: value rtol 1e-12, gradients 1e-10."""
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
