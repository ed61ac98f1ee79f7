"""PyTorch port, ``utils/profiling.py`` (the throughput counters and the
``torch.profiler`` trace) and ``noise_probe.py`` (the likelihood noise
probe) on the CPU: the counters against the JAX package's on the same calls,
the probe's values against the JAX log-joint at the same points.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcsd_tpu.utils import profiling as jprof
from gpcsd_tpu_torch import noise_probe, paper_run
from gpcsd_tpu_torch.utils import profiling as tprof
from torch_port_helpers import jax_small_model, port_of

torch.set_num_threads(2)


def test_throughput_counts_and_times_like_jax():
    """The same fields, count, rate and text as the JAX counter."""
    a = torch.randn(64, 64, dtype=torch.float64)
    mine, theirs = tprof.Throughput("evals"), jprof.Throughput("evals")
    for tp in (mine, theirs):
        for _ in range(2):
            with tp:
                for _ in range(5):
                    a @ a
                    tp.add()
    for tp in (mine, theirs):
        assert tp.count == 10 and tp.seconds > 0
        assert tp.rate == pytest.approx(10 / tp.seconds)
        assert str(tp).startswith("evals: 10 in ") and str(tp).endswith("/s")
    assert [f for f in vars(mine)] == [f for f in vars(theirs)]
    assert np.isnan(tprof.Throughput().rate)


def test_measure_evals_per_second_counts_calls():
    calls = []

    def fn(x):
        calls.append(x)
        return x * 2.0

    args = [(torch.full((8,), float(i)),) for i in range(6)]
    rate = tprof.measure_evals_per_second(fn, args, warmup=2)
    assert len(calls) == 8 and rate > 0
    assert [float(c[0]) for c in calls] == [0.0, 1.0, 0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    assert jprof.measure_evals_per_second(lambda x: jnp.asarray(x) * 2.0,
                                          [(np.ones(3),)] * 3) > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(32, 32, dtype=torch.float64)
    with tprof.trace(str(tmp_path / "trace")) as prof:
        (a @ a).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_probe_matches_jax_log_joint_on_a_toy_model():
    """33 values of ``-neg_log_joint`` along the segment equal the JAX
    package's at the same points to 1e-10 relative; on the CPU the
    quadratic fit's RMS residual is below 1e-6 of the segment's range."""
    jm = jax_small_model(per_channel=True, het_noise="exact")
    tm = port_of(jm)
    u0 = tm._fns().param_set.pack(tm._theta()).numpy()
    res = noise_probe.probe(tm, u0, scale=1e-2, npts=33, seed=0)
    du = np.random.default_rng(0).normal(size=u0.size)
    du /= np.linalg.norm(du)
    jfns, jY = jm._fns(), jm._Y()
    want = np.array([-float(jfns.neg_log_joint(jnp.asarray(u0 + t * du), jY)) for t in res["ts"]])
    np.testing.assert_allclose(res["ts"], np.linspace(-1e-2, 1e-2, 33), rtol=0, atol=0)
    np.testing.assert_allclose(res["logp"], want, rtol=1e-10, atol=0)
    assert res["center"] == res["logp"][16]
    assert res["range"] == pytest.approx(want.max() - want.min(), rel=1e-8)
    assert 0 < res["rms"] < 1e-6 * res["range"]
    assert res["rms"] <= res["max_abs_residual"]


def test_probe_command_line_on_the_paper_run_cache(tmp_path, capsys):
    """The command line reads ``surrogate_lfp.npz`` and ``map_params.pkl``
    from ``--out-dir`` (here a toy paper run's) and prints the figures as
    JSON for both noise models."""
    out = str(tmp_path / "run")
    os.makedirs(out)
    paper_run.build_model(out, 40, 3, 0, "cpu")  # a toy surrogate in the cache
    paper_run.fit_map(paper_run.build_model(out, 40, 3, 0, "cpu"), out, restarts=2, maxiter=4,
                      seed=0)
    for flags, het in (([], "approx"), (["--het-exact"], "exact")):
        assert noise_probe.main(["--out-dir", out, "--device", "cpu", "--npts", "9", *flags]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["het_noise"] == het and line["device"] == "cpu" and line["nvidia_smi"] is None
        assert line["npts"] == 9 and np.isfinite(line["center"]) and line["rms"] >= 0
    assert sorted(n for n in os.listdir(out) if not n.startswith("map_state")) == [
        "map_params.pkl", "surrogate_lfp.npz"]
