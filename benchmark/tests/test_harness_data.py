"""The frozen data generators pose the posteriors the repository's banked
runs did: equal to the program's own generators (``paper.paper_surrogate``,
``nuts_2d_probe.build_probe_model``) within 1e-10 at a small size; and each
configuration file states the priors, bounds and packing of the program's
model at full size."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import run as harness
from benchmark.tests.helpers import PACKAGE


def _config(name, **changes):
    cfg = json.loads((PACKAGE / "configs" / f"{name}.json").read_text())
    cfg.update(changes)
    return cfg, harness.load_module(PACKAGE / "configs" / f"{cfg['family']}.py", f"family_{name}")


@pytest.mark.parametrize("seed", [0, 2**31 + 12345])
def test_auditory_generator_is_paper_surrogate(seed):
    from gpcsd_tpu_torch import paper

    cfg, family = _config("auditory", surrogate_samples=40, nt=20, ntrials=3)
    data = family.make_data(cfg, seed)
    lfp, time_ms, truth = paper.paper_surrogate(seed, 40, 3, device="cpu")
    base = time_ms < 0
    np.testing.assert_allclose(data.lfp, lfp[:, base, :], rtol=1e-10, atol=0)
    np.testing.assert_array_equal(data.t, time_ms[base])
    for k, v in truth.items():
        assert data.truth[k] == pytest.approx(v, rel=1e-10)


@pytest.mark.parametrize("seed", [0, 2**31 + 12345])
def test_neuropixels_generator_is_probe_model(seed, tmp_path):
    from gpcsd_tpu_torch import nuts_2d_probe

    cfg, family = _config("neuropixels", nt=20, ntrials=3, ngl=[6, 10])
    data = family.make_data(cfg, seed)
    m = nuts_2d_probe.build_probe_model(str(tmp_path), seed, nt=20, ntrials=3, ngl1=6, ngl2=10,
                                        device="cpu")
    np.testing.assert_allclose(data.lfp, m.lfp, rtol=1e-10, atol=0)
    np.testing.assert_array_equal(data.x, m.x)
    np.testing.assert_array_equal(data.t, m.t.reshape(-1))
    assert data.truth["tm0_sigma2"] == pytest.approx(m.temporal_cov_list[0].params["sigma2"]["value"], rel=1e-10)
    assert data.truth["tm1_sigma2"] == pytest.approx(m.temporal_cov_list[1].params["sigma2"]["value"], rel=1e-10)


def _spec(ps):
    out = []
    for n in ps.names:
        s = ps.specs[n]
        p = s.priors[0]
        out.append((n, s.size, s.scale, type(p).__name__, getattr(p, "alpha", None),
                    getattr(p, "beta", None), getattr(p, "sd", None),
                    float(np.asarray(s.lo).reshape(-1)[0]), float(np.asarray(s.hi).reshape(-1)[0])))
    return out


def _stated(cfg):
    kinds = {"invgamma": "InvGamma", "halfnormal": "HalfNormal"}
    return [(p["name"], p["size"], p["scale"], kinds[p["prior"]["kind"]], p["prior"].get("alpha"),
             p["prior"].get("beta"), p["prior"].get("sd"), p["lo"],
             float("inf") if p["hi"] is None else p["hi"]) for p in cfg["params"]]


def test_auditory_config_is_paper_build_model():
    from gpcsd_tpu_torch import paper

    cfg, family = _config("auditory")
    time_ms = (np.arange(cfg["surrogate_samples"]) - cfg["surrogate_samples"] // 2) / cfg["fs_hz"] * 1000.0
    lfp = np.zeros((cfg["nx"], time_ms.size, 2))
    want = paper.build_model(lfp, time_ms, het_noise="exact", device="cpu")
    base = time_ms < 0
    x, _, _, _ = family.geometry(cfg)
    data = SimpleNamespace(lfp=lfp[:, base], t=time_ms[base], x=x, truth={
        "R": 1.0, "ell": 1.0, "tm0_ell": 1.0, "tm0_sigma2": 1.0, "tm1_ell": 1.0, "tm1_sigma2": 1.0,
        "sig2n": 1.0})
    got = family.build_program(cfg, data, "cpu")
    assert _spec(want._fns().param_set) == _stated(cfg) == _spec(got._fns().param_set)
    assert got.het_noise == want.het_noise and got.ngl == want.ngl and (got.a, got.b) == (want.a, want.b)


def test_neuropixels_config_is_neuropixels_problem():
    from gpcsd_tpu_torch import paper

    cfg, family = _config("neuropixels")
    want = paper.neuropixels_problem(0, ntrials=1, device="cpu")
    x, t, _, _, _ = family.geometry(cfg)
    data = SimpleNamespace(lfp=np.zeros((cfg["nx"], cfg["nt"], 1)), t=t, x=x, truth={
        "R": 1.0, "ell1": 1.0, "ell2": 1.0, "tm0_ell": 1.0, "tm0_sigma2": 1.0, "tm1_ell": 1.0,
        "tm1_sigma2": 1.0, "sig2n": 1.0})
    got = family.build_program(cfg, data, "cpu")
    assert _spec(want._fns().param_set) == _stated(cfg) == _spec(got._fns().param_set)
    assert (got.a1, got.b1, got.a2, got.b2, got.eps) == (want.a1, want.b1, want.a2, want.b2, want.eps)
    assert (got.ngl1, got.ngl2) == (want.ngl1, want.ngl2)
