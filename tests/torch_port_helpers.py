"""Shared by the ``test_torch_*`` files: the small model of
``tests/test_inference_api.py`` in the JAX package and its twin in the
PyTorch port (CPU float64), and feeds of pre-drawn random numbers for the
JAX package's ``jax.random`` calls."""

import jax.numpy as jnp
import numpy as np

import gpcsd_tpu as g
import gpcsd_tpu_torch as gt
from gpcsd_tpu_torch import convert


def jax_small_model(het_noise="approx", per_channel=False, seed=42, nx=6, nt=10, ntrials=4):
    rng = np.random.default_rng(seed)
    x = (np.arange(nx) * 100.0).reshape(-1, 1)
    t = np.arange(nt).reshape(-1, 1) * 1.0
    lfp = rng.normal(size=(nx, nt, ntrials)) * 0.5
    kw = {"sig2n_prior": [g.HalfNormal(0.1) for _ in range(nx)]} if per_channel else {}
    m = g.GPCSD1D(lfp, x, t, ngl=20, het_noise=het_noise, **kw)
    m.R["value"] = 120.0
    m.spatial_cov.params["ell"]["value"] = 180.0
    m.temporal_cov_list[0].params["ell"]["value"] = 4.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 0.5
    m.temporal_cov_list[1].params["ell"]["value"] = 1.5
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.3
    m.sig2n["value"] = rng.uniform(0.05, 0.15, size=nx) if per_channel else 0.1
    return m


def port_of(jm):
    """The port's model on the JAX model's data, priors and parameter values."""
    prior = jm.sig2n["prior"]
    prior = [gt.HalfNormal(p.sd) for p in prior] if isinstance(prior, list) else gt.HalfNormal(prior.sd)
    return convert.model_from_reference_params(
        jm.lfp, jm.x, jm.t, {k: np.asarray(v) for k, v in jm._theta().items()},
        a=jm.a, b=jm.b, ngl=jm.ngl, sig2n_prior=prior, het_noise=jm.het_noise, device="cpu",
    )


class RandomFeed:
    """Stand-ins for ``jax.random.normal`` / ``jax.random.uniform`` that hand
    out pre-drawn arrays in order, whatever the key, and check the shape
    asked for.  Under ``jax.disable_jit()`` a ``lax.scan`` or ``while_loop``
    body runs once per step, so a queue of draws reaches the JAX function
    in the order the port consumes its own."""

    def __init__(self, items):
        self.items = [np.asarray(a) for a in items]

    def __call__(self, key, shape=(), dtype=None, *args, **kwargs):
        a = self.items.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return jnp.asarray(a)
