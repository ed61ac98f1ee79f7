"""PyTorch port, ``sample_posterior`` end to end on a small model: moments
under Laplace whitening, and the port's posterior against the JAX
package's (CPU float64; the two samplers draw different random numbers, so
the comparison is by moments with stated Monte-Carlo tolerances).
"""

import numpy as np
import torch

from torch_port_helpers import jax_small_model, port_of

torch.set_num_threads(2)


def test_moments_invariant_under_whitening():
    """Laplace whitening is an exact constant linear reparameterization:
    posteriors with and without it agree in moments (the JAX test's loose
    Monte-Carlo tolerances; 2 x (100 + 100) each)."""
    small_model = port_of(jax_small_model())
    kw = dict(n_chains=2, num_warmup=100, num_samples=100, max_depth=5)
    post_w = small_model.sample_posterior(seed=5, laplace=True, **kw)
    post_p = small_model.sample_posterior(seed=6, laplace=False, **kw)
    for name in ("R", "ell", "tm0_ell", "sig2n"):
        a, b = np.log(post_w.theta[name]), np.log(post_p.theta[name])
        tol = 0.6 * max(a.std(), b.std()) + 0.15
        assert abs(a.mean() - b.mean()) < tol, (name, a.mean(), b.mean())


def test_posterior_means_match_jax():
    """The two packages' samplers on the same small model, same centre:
    every parameter's posterior mean in u within 0.3 posterior sd
    (4 x (100 + 200) draws each; the random streams differ)."""
    jm = jax_small_model()
    tm = port_of(jm)
    kw = dict(n_chains=4, num_warmup=100, num_samples=200, max_depth=5, seed=0)
    jpost = jm.sample_posterior(**kw)
    tpost = tm.sample_posterior(**kw)
    ju = np.asarray(jpost.raw.samples).reshape(-1, 7)
    tu = tpost.raw.samples.reshape(-1, 7).numpy()
    sd = ju.std(axis=0)
    assert np.all(np.abs(tu.mean(axis=0) - ju.mean(axis=0)) < 0.3 * sd)
    assert np.all(np.abs(np.log(tu.std(axis=0) / sd)) < 0.3)
    assert tpost.diagnostics["diverging"].mean() < 0.05
