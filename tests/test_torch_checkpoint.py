"""PyTorch port, ``io/checkpoint.py`` and the sampler's resume: parameter
pickles cross between the two packages' models, a sampler-state tree comes
back as it went, and NUTS stopped at a transition and started again gives
the draws of an uninterrupted run bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from gpcsd_tpu.io import checkpoint as jck
from gpcsd_tpu_torch.infer import nuts as tn
from gpcsd_tpu_torch.infer.hmc import DualAveragingState, da_init
from gpcsd_tpu_torch.io import checkpoint as tck
from torch_port_helpers import jax_small_model, port_of

torch.set_num_threads(2)


@pytest.mark.parametrize("per_channel", [False, True], ids=["scalar", "per_channel"])
def test_param_pickles_cross_between_packages(per_channel, tmp_path):
    """``extract_model_params`` of either package's model loads into the
    other's: same keys, same values (exact: the values are copied)."""
    jm = jax_small_model("exact", per_channel)
    tm = port_of(jm)
    tm.restore_model_params({"R": 50.0, "sig2n": 0.3, "spatial_ell": 90.0,
                             "temporal_ell_list": [1.0, 2.0], "temporal_sigma2_list": [3.0, 4.0]})
    jck.save_params(jm, str(tmp_path / "from_jax.pkl"))
    tck.load_params(tm, str(tmp_path / "from_jax.pkl"))
    want, got = jm.extract_model_params(), tm.extract_model_params()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], dtype=float), np.asarray(want[k], dtype=float))
    # and back: the port's pickle into a JAX model with other values
    tm.R["value"] = 99.0
    tck.save_params(tm, str(tmp_path / "sub" / "from_torch.pkl"))  # creates the directory
    jck.load_params(jm, str(tmp_path / "sub" / "from_torch.pkl"))
    assert jm.R["value"] == 99.0
    np.testing.assert_array_equal(np.asarray(jm.sig2n["value"]), np.asarray(tm.sig2n["value"]))
    assert np.isclose(float(jm.loglik()), tm.loglik(), rtol=1e-10)


def test_sampler_state_round_trip(tmp_path):
    """NamedTuples, dicts, lists, tuples, tensors, arrays and scalars come
    back with their types and exact values; no temporary is left."""
    gen = torch.Generator().manual_seed(3)
    state = {
        "next": 17,
        "da": da_init(torch.tensor([0.5, 2.0], dtype=torch.float64)),
        "carry": (torch.randn(2, 3, generator=gen, dtype=torch.float64), [np.arange(4), 2.5, None]),
        "flags": torch.tensor([True, False]),
        "counts": torch.arange(3),
        "generators": [gen.get_state().numpy()],
        "name": "run",
    }
    path = str(tmp_path / "deep" / "state")
    tck.save_sampler_state(state, path)
    assert tck.sampler_state_exists(path) and not tck.sampler_state_exists(path + "x")
    assert sorted(os.listdir(tmp_path / "deep")) == ["state.npz", "state.structure.pkl"]
    back = tck.load_sampler_state(path, device="cpu")
    assert back["next"] == 17 and back["name"] == "run"
    assert isinstance(back["da"], DualAveragingState)
    for a, b in zip(back["da"], state["da"]):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert isinstance(back["carry"], tuple) and isinstance(back["carry"][1], list)
    assert torch.equal(back["carry"][0], state["carry"][0])
    assert isinstance(back["carry"][1][0], np.ndarray) and back["carry"][1][1:] == [2.5, None]
    assert back["flags"].dtype == torch.bool and back["counts"].dtype == torch.int64
    # a generator restored from the saved state continues the same stream
    g2 = torch.Generator()
    g2.set_state(torch.from_numpy(back["generators"][0]))
    assert torch.equal(torch.randn(5, generator=g2), torch.randn(5, generator=gen))
    # a second save replaces the first atomically
    tck.save_sampler_state({"next": 18}, path)
    assert tck.load_sampler_state(path, device="cpu") == {"next": 18}
    with pytest.raises(TypeError, match="cannot checkpoint"):
        tck.save_sampler_state({"f": lambda: 0}, path)
    with pytest.raises(FileNotFoundError):
        tck.load_sampler_state(str(tmp_path / "absent"), device="cpu")


def _target(z):
    scales = torch.tensor([1.0, 0.3, 3.0], dtype=z.dtype)
    return -0.5 * torch.sum(torch.square(z / scales), dim=-1) - 0.1 * z[..., 0] * z[..., 1]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("stop_at,save_every,dense", [
    (12, 1, True),   # in warmup, after a pooled window
    (33, 1, False),  # in sampling
    (31, 4, True),   # between two saves: continues from the last save
], ids=["warmup", "sampling", "between_saves"])
def test_nuts_resume_is_bit_identical(stop_at, save_every, dense, tmp_path):
    """A run whose callback raises at ``stop_at`` and that is started again
    with the same arguments equals the uninterrupted run in every field,
    bit for bit (the state holds the carry, the buffers and every chain's
    generator state)."""
    u0s = torch.tensor(np.random.default_rng(0).normal(size=(3, 3)))
    kw = dict(num_warmup=30, num_samples=10, max_depth=4, dense_mass=dense, pool_warmup=True)
    whole = tn.nuts_chains(_target, u0s, tn.chain_generators(5, 3), **kw)

    def cb(i, carry):
        if i == stop_at:
            raise _Stop

    path = str(tmp_path / "nuts_state")
    with pytest.raises(_Stop):
        tn.nuts_chains(_target, u0s, tn.chain_generators(5, 3), state_path=path,
                       save_every=save_every, callback=cb, **kw)
    seen = []
    res = tn.nuts_chains(_target, u0s, tn.chain_generators(5, 3), state_path=path,
                         save_every=save_every, callback=lambda i, c: seen.append(i), **kw)
    assert seen[0] == (stop_at + 1) // save_every * save_every and seen[-1] == 39
    for name, a, b in zip(whole._fields, res, whole):
        assert torch.equal(a, b), name
    # a finished run's state is at the end: a rerun samples nothing more
    again = tn.nuts_chains(_target, u0s, tn.chain_generators(5, 3), state_path=path,
                           save_every=save_every, callback=lambda i, c: seen.append(-1), **kw)
    assert -1 not in seen and torch.equal(again.samples, whole.samples)
    with pytest.raises(ValueError, match="another run"):
        tn.nuts_chains(_target, u0s, tn.chain_generators(5, 3), state_path=path,
                       **{**kw, "num_samples": 11})


def test_sample_posterior_resumes(tmp_path):
    """The same through ``sample_posterior(state_path=...)`` on a small
    GPCSD1D model with whitening: stopped in warmup, finished, equal."""
    tm = port_of(jax_small_model("exact", True))
    kw = dict(n_chains=2, num_warmup=12, num_samples=6, seed=0, max_depth=4, dense_mass=True)
    whole = tm.sample_posterior(**kw)

    def cb(i, carry):
        if i == 9:
            raise _Stop

    path = str(tmp_path / "st")
    with pytest.raises(_Stop):
        tm.sample_posterior(state_path=path, save_every=5, callback=cb, **kw)
    res = tm.sample_posterior(state_path=path, save_every=5, **kw)
    assert torch.equal(res.raw.samples, whole.raw.samples)
    np.testing.assert_array_equal(res.theta["sig2n"], whole.theta["sig2n"])
    np.testing.assert_array_equal(res.diagnostics["num_steps"], whole.diagnostics["num_steps"])
