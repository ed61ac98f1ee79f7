"""PyTorch port, host I/O: the native text parser (``gpcsd_tpu_torch.native``),
the loaders and the NWB utilities, against the JAX package's modules and
``np.loadtxt`` on the same files (twins of ``tests/test_native_io.py`` and
``tests/test_nwb.py``); and the real-data modes of the auditory and evoked
workload twins on reference-format files written here (mirroring
``tests/test_workloads.py::TestFitMeanFunction::test_real_data_mode``).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from gpcsd_tpu.io import loaders as jl
from gpcsd_tpu.io import nwb as jn
from gpcsd_tpu_torch import native
from gpcsd_tpu_torch.io import loaders as tl
from gpcsd_tpu_torch.io import nwb as tn

torch.set_num_threads(2)

PROBE = "probeC"
N_CH = 12  # recorded channels (subset of the 384 probe sites)


@pytest.fixture
def matrix_files(tmp_path, rng):
    paths, mats = [], []
    for i in range(4):
        M = rng.normal(size=(50, 20)) * 10.0 ** rng.integers(-8, 8)
        p = tmp_path / f"m{i}.txt"
        np.savetxt(p, M)
        paths.append(str(p))
        mats.append(M)
    return paths, mats


class TestNative:
    def test_builds_into_the_build_dir(self):
        """g++ builds the port's own copy of the parser into ``_build/``, under
        a name keyed on the source and flags, without ``-march=native``."""
        L = native.lib()
        assert L is not None
        so = native.library_path()
        assert so.exists() and so.parent.name == "_build" and so.parent.parent.name == "gpcsd_tpu_torch"
        assert so.name.startswith("libfastio_") and len(so.stem) == len("libfastio_") + 16
        assert "-march=native" not in native.CXX_FLAGS
        assert native.build() == so  # built once, then reused
        assert native.compiler_version()
        for fn in ("fastio_count", "fastio_load", "fastio_load_many"):
            assert hasattr(L, fn)

    def test_source_is_the_jax_parser(self):
        """Same C ABI and the same parser as the JAX package's ``fastio.cpp``:
        the two files differ only in their header comment and includes."""
        here = os.path.dirname(os.path.abspath(__file__))
        jax_src = open(os.path.join(here, "..", "gpcsd_tpu", "native", "fastio.cpp")).read()
        port_src = native.SOURCE.read_text()
        body = jax_src[jax_src.index("namespace {"):]
        assert port_src.endswith(body)


class TestLoadtxt:
    def test_matches_jax_and_numpy(self, matrix_files):
        paths, mats = matrix_files
        for p, M in zip(paths, mats):
            got = tl.loadtxt_matrix(p)
            assert got.shape == M.shape
            assert np.array_equal(got, np.loadtxt(p))
            assert np.array_equal(got, jl.loadtxt_matrix(p))

    def test_stack(self, matrix_files):
        paths, mats = matrix_files
        got = tl.load_electrode_stack(paths)
        assert got.shape == (4, 50, 20)
        assert np.array_equal(got, jl.load_electrode_stack(paths))
        assert np.array_equal(got, np.stack([np.loadtxt(p) for p in paths]))

    def test_numpy_fallback(self, matrix_files, monkeypatch):
        """Without the library the loaders give np.loadtxt's arrays."""
        paths, _ = matrix_files
        native_stack = tl.load_electrode_stack(paths)
        monkeypatch.setattr(tl, "_native_lib", lambda: None)
        assert np.array_equal(tl.load_electrode_stack(paths), native_stack)
        assert np.array_equal(tl.loadtxt_matrix(paths[0]), native_stack[0])

    def test_missing_file(self, tmp_path):
        with pytest.raises((FileNotFoundError, OSError)):
            tl.loadtxt_matrix(str(tmp_path / "nope.txt"))
        with pytest.raises((FileNotFoundError, OSError)):
            tl.load_electrode_stack([str(tmp_path / "nope.txt")])

    def test_scientific_and_int_formats(self, tmp_path):
        p = tmp_path / "mixed.txt"
        p.write_text("1 2.5 -3e-4\n4.0E+2 -5 6.25\n")
        got = tl.loadtxt_matrix(str(p))
        assert np.array_equal(got, [[1, 2.5, -3e-4], [400.0, -5, 6.25]])

    def test_parser_bit_exact_vs_numpy(self, tmp_path):
        """Fast-path (<=15 digits) and strtod-fallback (18-digit) tokens are
        both correctly rounded: bit-identical to np.loadtxt and to JAX's."""
        rng = np.random.default_rng(3)
        A = rng.normal(size=(40, 7)) * np.logspace(-12, 12, 7)[None, :]
        for fmt in ("%.6f", "%.15g", "%.18e"):
            p = str(tmp_path / f"fmt_{fmt.strip('%.')}.txt")
            np.savetxt(p, A, fmt=fmt)
            got = tl.loadtxt_matrix(p)
            assert np.array_equal(got, np.loadtxt(p)), fmt
            assert np.array_equal(got, jl.loadtxt_matrix(p)), fmt

    def test_stack_binary_cache(self, matrix_files, tmp_path):
        """The cache is written with its sidecar, served while newer than
        every source, and refused once a source is rewritten."""
        paths, mats = matrix_files
        cp = str(tmp_path / "stack.npy")
        a = tl.load_electrode_stack(paths, cache_path=cp)
        assert np.array_equal(a, np.stack([np.loadtxt(p) for p in paths]))
        assert os.path.exists(cp) and os.path.exists(cp + ".meta.json")
        # served: a marked cache comes back as it is
        np.save(cp, a + 1.0)
        later = max(os.path.getmtime(p) for p in paths) + 10
        os.utime(cp, (later, later))
        assert np.array_equal(tl.load_electrode_stack(paths, cache_path=cp), a + 1.0)
        # JAX's loader reads the same cache and sidecar
        assert np.array_equal(jl.load_electrode_stack(paths, cache_path=cp), a + 1.0)
        # refused: a source rewritten after the cache
        new = np.full((50, 20), 7.25)
        np.savetxt(paths[0], new)
        os.utime(paths[0], (later + 10, later + 10))
        b = tl.load_electrode_stack(paths, cache_path=cp)
        assert np.array_equal(b[0], new) and np.array_equal(b[1:], a[1:])
        # and rewritten: the next call serves the fresh parse
        assert np.array_equal(np.load(cp), b)

    def test_cache_keyed_on_the_path_list(self, matrix_files, tmp_path):
        paths, _ = matrix_files
        cp = str(tmp_path / "stack.npy")
        a = tl.load_electrode_stack(paths, cache_path=cp)
        b = tl.load_electrode_stack(paths[::-1], cache_path=cp)
        assert np.array_equal(b, a[::-1])


def write_auditory(dirpath, lfp_by_probe, time_s):
    """Reference-format auditory files: ``time.txt`` in seconds and one
    ``<probe>_electrode<i>.txt`` of (ntime, ntrials) values x100 per
    electrode."""
    os.makedirs(dirpath, exist_ok=True)
    np.savetxt(os.path.join(dirpath, "time.txt"), time_s)
    for probe, lfp in lfp_by_probe.items():
        for i in range(lfp.shape[0]):
            np.savetxt(os.path.join(dirpath, f"{probe}_electrode{i + 1}.txt"), 100.0 * lfp[i])


def test_load_auditory_probe_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    lfp = rng.normal(size=(24, 30, 6))
    time_s = (np.arange(30) - 15) / 1000.0
    write_auditory(str(tmp_path), {"lateral": lfp}, time_s)
    for demean in (True, False):
        got, t = tl.load_auditory_probe(str(tmp_path), "lateral", demean=demean, cache=False)
        want, wt = jl.load_auditory_probe(str(tmp_path), "lateral", demean=demean, cache=False)
        assert np.array_equal(got, want) and np.array_equal(t, wt)
        expect = lfp - lfp.mean(axis=2, keepdims=True) if demean else lfp
        assert np.max(np.abs(got - expect)) <= 1e-12 * np.max(np.abs(expect))
    np.testing.assert_allclose(t, time_s * 1000.0, rtol=1e-15)
    cached, _ = tl.load_auditory_probe(str(tmp_path), "lateral")
    assert os.path.isfile(tmp_path / ".gpcsd_cache_lateral.npy")
    assert np.array_equal(tl.load_auditory_probe(str(tmp_path), "lateral")[0], cached)


# ---------------------------------------------------------------- NWB


def test_channel_geometry_equals_jax():
    for ch in range(384):
        assert tn.channel_location(ch) == jn.channel_location(ch)
    chans = np.arange(0, 384, 7)
    np.testing.assert_array_equal(tn.probe_geometry(chans), jn.probe_geometry(chans))
    assert tn.REFERENCE_CHANNELS == jn.REFERENCE_CHANNELS and tn.ROI_CODES == jn.ROI_CODES


def test_epoch_trials_equals_jax():
    rng = np.random.default_rng(2)
    data = rng.normal(size=(4 * tn.LFP_SAMPLE_RATE, 10))
    ts = np.arange(data.shape[0]) / tn.LFP_SAMPLE_RATE
    onsets = np.array([0.2, 1.0, 1.7, 3.9])  # the first and last clamp at the edges
    got = tn.epoch_trials(data, ts, onsets, [1, 4, 7])
    want = jn.epoch_trials(data, ts, onsets, [1, 4, 7])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (3, tn.LFP_SAMPLE_RATE, 4)


@pytest.fixture
def nwb_pair(tmp_path):
    """Synthetic (lfp.nwb, spikes.nwb) pair as ``tests/test_nwb.py`` builds
    it: 12 recorded channels, units labeling channels 0-3 visual, 4-5 CA,
    6 thalamus; 3 flash trials; channel 0 carries a trial-locked pulse."""
    h5py = pytest.importorskip("h5py")
    nsamp = 3 * tn.LFP_SAMPLE_RATE
    rng = np.random.default_rng(0)
    lfp_path, spk_path = tmp_path / "mouse.lfp.nwb", tmp_path / "mouse.spikes.nwb"
    with h5py.File(lfp_path, "w") as f:
        grp = f.create_group(f"acquisition/timeseries/{PROBE}")
        data = rng.normal(size=(nsamp, N_CH))
        data[:, 0] = 0.0
        for onset in (1.0, 1.6, 2.2):
            i0 = int(onset * tn.LFP_SAMPLE_RATE)
            data[i0 : i0 + 50, 0] = 7.0
        grp.create_dataset("data", data=data)
        grp.create_dataset("timestamps", data=np.arange(nsamp) / tn.LFP_SAMPLE_RATE)
        grp.create_dataset("electrode_idx", data=np.arange(N_CH))
    with h5py.File(spk_path, "w") as f:
        proc = f.create_group(f"processing/{PROBE}")
        structures = {0: b"VISp", 1: b"VISp", 2: b"VISp5", 3: b"VISp6a",
                      4: b"CA1", 5: b"CA3", 6: b"TH", 7: None}
        proc.create_dataset("unit_list", data=np.arange(len(structures)))
        for unit, struct in structures.items():
            ug = proc.create_group(f"UnitTimes/{unit}")
            ug.create_dataset("channel", data=unit)
            if struct is not None:
                ug.create_dataset("ccf_structure", data=struct)
        st = f.create_group("stimulus/presentation/flash_250ms_1")
        st.create_dataset("timestamps", data=np.array([[1.0, 1.25], [1.6, 1.85], [2.2, 2.45]]))
    return str(lfp_path), str(spk_path)


def test_channel_region_labels_equal_jax(nwb_pair):
    import h5py

    with h5py.File(nwb_pair[1], "r") as f:
        got = tn.channel_region_labels(f, PROBE)
        want = jn.channel_region_labels(f, PROBE)
    np.testing.assert_array_equal(got, want)
    assert list(got[:8]) == [1, 1, 1, 1, 2, 2, 4, 0] and (got[8:] == 0).all()


@pytest.mark.parametrize("region", ["V", None])
def test_extract_probe_equals_jax(nwb_pair, tmp_path, region):
    out_path = str(tmp_path / "viz.pkl")
    got = tn.extract_probe(*nwb_pair, PROBE, out_path=out_path, region=region, roi_name="V1")
    want = jn.extract_probe(*nwb_pair, PROBE, region=region, roi_name="V1")
    assert set(got) == set(want) == {"x", "t", "y", "fs", "roi", "regions"}
    for k in got:
        if isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]
    assert got["y"].shape == ((4 if region else N_CH), tn.LFP_SAMPLE_RATE, 3)
    t = got["t"].reshape(-1)
    post = (t > 0.0) & (t < 0.02 - 1e-9)
    assert (got["y"][0][post, :] > 0.9 * 7.0 * 0.195).all()
    with open(out_path, "rb") as f:
        saved = pickle.load(f)
    assert set(saved) == set(got)
    np.testing.assert_array_equal(saved["y"], got["y"])


# ---------------------------------------------------- real-data modes


def test_auditory_real_data_mode(tmp_path):
    """The auditory twin on reference-format text files (two probes, 24
    electrodes, 120 samples, 20 trials; the JAX auditory test's size): the
    files are read (cached), fitted, and the pipeline holds the JAX test's
    thresholds."""
    from gpcsd_tpu_torch.workloads import auditory_lfp as TA

    probes = TA.surrogate(4, 120, 20, device="cpu")
    time_ms = probes["lateral"][1]
    data = str(tmp_path / "aud")
    write_auditory(data, {p: lfp for p, (lfp, _) in probes.items()}, time_ms / 1000.0)
    lfp, t = TA.load_probe(data, "medial")
    want = probes["medial"][0] - probes["medial"][0].mean(axis=2, keepdims=True)
    assert np.max(np.abs(lfp - want)) <= 1e-12 * np.max(np.abs(want))
    np.testing.assert_allclose(t, time_ms, rtol=1e-12, atol=1e-12)

    timings = {}
    m, phases, tg = TA.run(data_dir=data, n_restarts=2, nboot=2, seed=4,
                           results_dir=str(tmp_path / "out"), device="cpu", timings=timings)
    assert m["source"] == "zenodo"
    assert phases["lateral"]["csd"].shape == (24, 20)
    assert torch.isfinite(tg.pvals).all()
    assert 0 <= m["tg_edges_bonf_001"] <= 1128
    assert "load" in timings and "surrogate" not in timings
    assert os.path.isfile(os.path.join(data, ".gpcsd_cache_lateral.npy"))
    assert os.path.isfile(tmp_path / "out" / "gpcsd_model_lateral.pkl")
    TA.main(["--data-dir", data, "--quick", "--device", "cpu"])


def test_fit_mean_function_real_data_mode(tmp_path):
    """Reference-format text data + stage-1 pickle restore (reference
    ``fit_mean_function.py:55-128``), as the JAX test builds them."""
    from gpcsd_tpu_torch.ops.forward import fwd_model_1d
    from gpcsd_tpu_torch.workloads.auditory_lfp import A, B, NX, fit_probe
    from gpcsd_tpu_torch.workloads.fit_mean_function import _template_components, run_real

    rng = np.random.default_rng(0)
    ntime, ntrials = 120, 8
    time_s = (np.arange(ntime) - 60) / 1000.0
    t_ms = time_s * 1000.0
    x = np.linspace(A, B, NX)
    z = np.linspace(A, B, 60)
    comps = _template_components(z, np.clip(t_ms, 0.0, None))
    csd = (comps[0] + comps[1]) * (t_ms >= 0)[None, :]
    lfp_e = fwd_model_1d(csd, z, x, 150.0).numpy()
    lfp = lfp_e[:, :, None] + 0.05 * np.max(np.abs(lfp_e)) * rng.standard_normal((NX, ntime, ntrials))
    data = str(tmp_path / "aud")
    write_auditory(data, {"lateral": lfp, "medial": lfp}, time_s)

    # stage-1 pickle written by a quick baseline-style fit
    stage1 = tmp_path / "stage1"
    stage1.mkdir()
    widx = (t_ms >= 0) & (t_ms <= 150.0)
    fit_probe(lfp[:, widx, :], t_ms[widx], n_restarts=1, seed=0,
              cache=str(stage1 / "gpcsd_model_lateral.pkl"), device="cpu")

    timings = {}
    m, results = run_real(data, stage1_dir=str(stage1), n_restarts=1, gdx=50.0,
                          probes=("lateral",), device="cpu", timings=timings)
    assert m["source"] == "zenodo"
    assert m["lateral_stage1_restored"] is True
    assert np.isfinite(m["lateral_kcsd_gpcsd_corr"])
    assert m["lateral_n_segments"] >= 1
    assert 0.0 <= m["lateral_converged_frac"] <= 1.0
    assert set(timings) == {"load", "fit", "predict", "kcsd", "segmentation", "shifts"}
    assert results["lateral"]["evoked_csd"].shape == (47, int(widx.sum()))
