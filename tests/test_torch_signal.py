"""PyTorch port, ``signal``: each function against the JAX package's and
against scipy (the reference pipelines' backend) on the same numpy inputs,
CPU float64, at odd and even lengths and several batch shapes.

Tolerance 1e-12 of the largest magnitude for the filters, the analytic
signal, the periodogram and the PLV.  The port filters by one linear map
per section over the whole signal where JAX scans the recursion over time:
the two differ by rounding only (~5e-14).  Phases are compared through
exp(i phi), never phi (a rounding can turn pi into -pi), and to 1e-9: the
phase error is the analytic signal's relative error over its local
amplitude, which is small where the band-passed signal crosses zero in
both its parts.
"""

import numpy as np
import pytest
import scipy.signal as ss
import torch

from gpcsd_tpu import signal as jsig
from gpcsd_tpu_torch import signal as tsig

TOL = 1e-12
SHAPES = [(199,), (3, 200), (2, 5, 253), (4, 64)]


def max_rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want)))


def signal_of(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).cumsum(axis=-1) * 0.1 + rng.normal(size=shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("band", [(8.0, 12.0, 1000.0), (3.0, 7.0, 250.0)])
def test_filters_match_jax_and_scipy(shape, band):
    x = signal_of(shape)
    sos = tsig.butter_bandpass_sos(*band)
    assert np.array_equal(sos, jsig.butter_bandpass_sos(*band))
    got = tsig.sosfilt(sos, x, device="cpu").numpy()
    assert max_rel(got, ss.sosfilt(sos, x, axis=-1)) <= TOL
    assert max_rel(got, jsig.sosfilt(sos, x)) <= TOL
    got = tsig.sosfiltfilt(sos, x, device="cpu").numpy()
    assert max_rel(got, jsig.sosfiltfilt(sos, x)) <= TOL
    if shape[-1] > 27:  # scipy refuses a signal no longer than its padding
        assert max_rel(got, ss.sosfiltfilt(sos, x, axis=-1)) <= TOL


def test_sosfilt_initial_state_and_axis():
    x = signal_of((3, 150, 4))
    sos = tsig.butter_bandpass_sos(8.0, 12.0, 1000.0)
    zi = np.random.default_rng(1).normal(size=(sos.shape[0], 12, 2))
    got = tsig.sosfilt(sos, x, axis=1, zi=zi, device="cpu").numpy()
    want = np.asarray(jsig.sosfilt(sos, x, axis=1, zi=zi))
    assert max_rel(got, want) <= TOL
    got = tsig.bandpass_filtfilt(x, 8.0, 12.0, 1000.0, axis=1, device="cpu").numpy()
    assert max_rel(got, ss.sosfiltfilt(sos, x, axis=1)) <= TOL
    assert max_rel(got, jsig.bandpass_filtfilt(x, 8.0, 12.0, 1000.0, axis=1)) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_hilbert_phase_periodogram(shape):
    x = signal_of(shape, seed=2)
    got = tsig.hilbert(x, device="cpu").numpy()
    assert got.dtype == np.complex128
    assert max_rel(got, ss.hilbert(x, axis=-1)) <= TOL
    assert max_rel(got, jsig.hilbert(x)) <= TOL
    filt = tsig.bandpass_filtfilt(x, 8.0, 12.0, 1000.0, device="cpu")
    ph = tsig.instantaneous_phase(filt, device="cpu").numpy()
    ph_j = np.asarray(jsig.instantaneous_phase(jsig.bandpass_filtfilt(x, 8.0, 12.0, 1000.0)))
    assert np.max(np.abs(np.exp(1j * ph) - np.exp(1j * ph_j))) <= 1e-9
    f, p = tsig.periodogram(x, fs=250.0, device="cpu")
    f_s, p_s = ss.periodogram(x, fs=250.0, axis=-1)
    f_j, p_j = jsig.periodogram(x, fs=250.0)
    assert np.array_equal(f.numpy(), f_s) and np.allclose(f.numpy(), np.asarray(f_j), rtol=0, atol=1e-12)
    assert max_rel(p, p_s) <= TOL and max_rel(p, p_j) <= TOL


def test_periodogram_axis_and_no_detrend():
    x = signal_of((40, 3), seed=3) + 2.0
    f, p = tsig.periodogram(x, fs=10.0, axis=0, detrend=False, device="cpu")
    f_j, p_j = jsig.periodogram(x, fs=10.0, axis=0, detrend=False)
    assert max_rel(p, p_j) <= TOL


@pytest.mark.parametrize("nchan,ntrials", [(24, 60), (5, 7)])
def test_plv_matrix(nchan, ntrials):
    ph = np.random.default_rng(4).uniform(-np.pi, np.pi, size=(nchan, ntrials))
    got = tsig.plv_matrix(ph, device="cpu").numpy()
    assert max_rel(got, jsig.plv_matrix(ph)) <= TOL
    assert np.allclose(np.diag(got), 1.0, atol=1e-14)


def test_results_stay_on_the_requested_device():
    x = torch.tensor(signal_of((2, 50)))
    for out in (tsig.sosfiltfilt(tsig.butter_bandpass_sos(8, 12, 1000.0), x, device="cpu"),
                tsig.hilbert(x, device="cpu"), tsig.periodogram(x, device="cpu")[1]):
        assert out.device.type == "cpu"
    assert tsig.hilbert(x, device="cpu").dtype == torch.complex128
