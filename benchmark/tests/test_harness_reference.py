"""The plain reference against the program on the CPU, at small sizes, for
both configurations: the log-density, the MAP objective and their gradients,
at the generating point and away from it; and the reference's gradient
against central differences of its own value."""

import numpy as np
import pytest
import torch

from benchmark import run as harness
from benchmark.tests.helpers import PACKAGE, small_config


def _problem(name, seed=5):
    cfg = small_config(name)
    family = harness.load_module(PACKAGE / "configs" / f"{cfg['family']}.py", f"family_{name}")
    data = family.make_data(cfg, seed)
    model = family.build_program(cfg, data, "cpu")
    ref = family.reference_problem(cfg, data, torch.float64, "cpu")
    return model, ref, ref.pack(data.truth)


def _program(model, u, jacobian):
    fns, Y = model._fns(), model._Y()
    ut = torch.tensor(u, requires_grad=True)
    f = fns.log_prob(ut, Y) if jacobian else -fns.neg_log_joint(ut, Y)
    (g,) = torch.autograd.grad(f, ut)
    return float(f.detach()), g.numpy()


@pytest.mark.parametrize("name", ["auditory", "neuropixels"])
@pytest.mark.parametrize("jacobian", [True, False])
def test_reference_matches_program(name, jacobian):
    model, ref, c = _problem(name)
    rng = np.random.default_rng(0)
    for u in (c, c + 0.05 * rng.standard_normal(c.size)):
        f_ref, g_ref = ref.value_and_grad(u, jacobian=jacobian)
        f, g = _program(model, u, jacobian)
        assert abs(f - f_ref) <= 1e-10 * abs(f_ref)
        assert np.linalg.norm(g - g_ref) <= 1e-6 * np.linalg.norm(g_ref)
        assert ref.value(u, jacobian=jacobian) == pytest.approx(f_ref, rel=1e-13)


@pytest.mark.parametrize("name", ["auditory", "neuropixels"])
def test_reference_gradient_is_its_values_derivative(name):
    _, ref, c = _problem(name)
    _, g = ref.log_prob(c)
    h = 1e-5
    for i in range(c.size):
        e = np.zeros(c.size)
        e[i] = h
        fd = (ref.log_prob(c + e)[0] - ref.log_prob(c - e)[0]) / (2 * h)
        assert fd == pytest.approx(g[i], rel=1e-4, abs=1e-4 * np.abs(g).max())


def test_reference_bounds_and_packing_match_program():
    model, ref, c = _problem("auditory")
    ps = model._fns().param_set
    lo, hi = ref.bounds()
    np.testing.assert_allclose(lo, ps.bounds()[0], rtol=0, atol=0)
    np.testing.assert_array_equal(hi, ps.bounds()[1])
    np.testing.assert_allclose(c, ps.pack(model._theta()).numpy(), rtol=1e-15)
