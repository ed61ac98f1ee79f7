"""Signal processing for the workload pipelines, counterpart of
``gpcsd_tpu.signal``.

The reference pipelines lean on scipy.signal for phase extraction:
- Butterworth bandpass + ``filtfilt`` 8-12 Hz (``auditory_lfp/
  fit_gpcsd_baseline.py:292-308``), ``sosfiltfilt`` theta/beta bands
  (``neuropixels/fit_gpcsd2d.py:140-159``)
- ``hilbert`` -> instantaneous phases, PLV matrices
  (``fit_gpcsd_baseline.py:303-322``)
- periodograms (``fit_gpcsd_baseline.py:189-269``)

Filter *design* stays on the host (scipy, static coefficients).  The JAX
package applies the filter as a ``lax.scan`` over time with the sections
cascaded inside each step; eager PyTorch would pay a few launches per time
step and section.  Here each second-order section is one linear map over
the whole signal, applied to every channel and trial at once: with zero
initial state a section's output is its impulse response convolved with
the input, so ``y = x @ H_s^T`` with ``H_s`` the (n, n) lower-triangular
Toeplitz matrix of that response, and a nonzero initial state ``(z1, z2)``
adds ``z1 g_s1 + z2 g_s2``, the section's responses to unit states.
``H_s`` and ``g_s`` are computed on the host by scipy's own recursion
(float64); the device does one GEMM per section.  The result differs from
the recursion only by rounding (~5e-14 of the largest output at the
auditory window).  Memory is ``8 n^2`` bytes per section, meant for the
trial windows of these pipelines (a few thousand samples at most).

Every function works in float64 (complex128 for the analytic signal) on
``device``, where a host array or another device's tensor is moved first:
the card unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as _ss
import torch

from . import config


def butter_bandpass_sos(low_hz, high_hz, fs, order=4):
    """Design a Butterworth bandpass as second-order sections (host-side)."""
    return np.asarray(
        _ss.butter(order, [low_hz, high_hz], btype="bandpass", fs=fs, output="sos")
    )


def _section_maps(sos, n, device):
    """Per section, ``(H_s^T, G_s)`` on ``device``: the transposed (n, n)
    Toeplitz matrix of its impulse response and the (2, n) responses to the
    unit initial states (1, 0) and (0, 1), from scipy's recursion."""
    sos = np.asarray(sos, dtype=np.float64)
    lag = np.subtract.outer(np.arange(n), np.arange(n))  # lag[i, j] = i - j
    delta = np.zeros(n)
    delta[0] = 1.0
    maps = []
    for sec in sos[:, None, :]:
        h = _ss.sosfilt(sec, delta)
        H = np.where(lag >= 0, h[np.clip(lag, 0, None)], 0.0)
        G = np.stack([_ss.sosfilt(sec, np.zeros(n), zi=np.array([unit]))[0]
                      for unit in ([1.0, 0.0], [0.0, 1.0])])
        maps.append((torch.as_tensor(np.ascontiguousarray(H.T), device=device),
                     torch.as_tensor(G, device=device)))
    return maps


def _apply_sections(maps, xf, zi):
    """Cascade the sections over ``xf`` (B, n); ``zi`` is None or (nsec, B, 2)."""
    y = xf
    for s, (Ht, G) in enumerate(maps):
        y = y @ Ht if zi is None else torch.addmm(zi[s] @ G, y, Ht)
    return y


def sosfilt(sos, x, axis=-1, zi=None, device=config.DEFAULT_DEVICE):
    """Causal SOS filter along ``axis`` (``scipy.signal.sosfilt``'s output
    for ``zi=None``, its first output otherwise).

    :param zi: optional initial conditions, broadcastable to (nsec, B, 2)
        where B is the flattened batch size.
    """
    x = torch.movedim(config.on_device(x, device), axis, -1)
    batch, n = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, n)
    nsec = np.asarray(sos).shape[0]
    if zi is not None:
        zi = torch.broadcast_to(config.on_device(zi, x.device), (nsec, xf.shape[0], 2))
    y = _apply_sections(_section_maps(sos, n, x.device), xf, zi)
    return torch.movedim(y.reshape(*batch, n), -1, axis)


def sosfiltfilt(sos, x, axis=-1, padlen=None, device=config.DEFAULT_DEVICE):
    """Zero-phase forward-backward SOS filtering with odd-reflection padding
    and ``sosfilt_zi`` initial states scaled by each pass's first sample
    (``scipy.signal.sosfiltfilt``'s default semantics).

    On the card one call launches 4 nsec + 12 kernels, whatever the batch
    and the length: the padding (7), per pass the scaled initial states (1)
    and per section ``zi @ G`` and the ``addmm`` (2), the two flips and the
    copy of the final slice; and it copies 2 nsec + 1 small arrays (the
    maps and ``sosfilt_zi``) to the device.  At the auditory window (199
    samples padded to 253, 4 sections) that is 28 launches and 9 copies,
    where a scan over time would launch ~6 kernels per sample, section and
    pass (~12,000).
    """
    x = torch.movedim(config.on_device(x, device), axis, -1)
    batch, n = x.shape[:-1], x.shape[-1]
    sos = np.asarray(sos, dtype=np.float64)
    nsec = sos.shape[0]
    if padlen is None:
        padlen = 3 * (2 * nsec + 1)  # scipy default
    padlen = min(padlen, n - 1)
    # odd extension: 2*x[0] - x[pad:0:-1] ... on both ends
    left = 2 * x[..., :1] - torch.flip(x[..., 1 : padlen + 1], [-1])
    right = 2 * x[..., -1:] - torch.flip(x[..., n - padlen - 1 : n - 1], [-1])
    ext = torch.cat([left, x, right], dim=-1).reshape(-1, n + 2 * padlen)
    maps = _section_maps(sos, ext.shape[-1], x.device)
    zi0 = torch.as_tensor(_ss.sosfilt_zi(sos), device=x.device)  # (nsec, 2)

    def _pass(v):
        return _apply_sections(maps, v, zi0[:, None, :] * v[None, :, :1])

    y = torch.flip(_pass(torch.flip(_pass(ext), [-1])), [-1])
    y = y[:, padlen : padlen + n].reshape(*batch, n)
    return torch.movedim(y, -1, axis)


def bandpass_filtfilt(x, low_hz, high_hz, fs, order=4, axis=-1, device=config.DEFAULT_DEVICE):
    """Zero-phase Butterworth bandpass (design on the host, apply on ``device``)."""
    sos = butter_bandpass_sos(low_hz, high_hz, fs, order=order)
    return sosfiltfilt(sos, x, axis=axis, device=device)


def hilbert(x, axis=-1, device=config.DEFAULT_DEVICE):
    """Analytic signal via FFT (``scipy.signal.hilbert`` semantics), complex128."""
    x = torch.movedim(config.on_device(x, device), axis, -1)
    n = x.shape[-1]
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1 : n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1 : (n + 1) // 2] = 2.0
    xa = torch.fft.ifft(torch.fft.fft(x, dim=-1) * torch.as_tensor(h, device=x.device), dim=-1)
    return torch.movedim(xa, -1, axis)


def instantaneous_phase(x, axis=-1, device=config.DEFAULT_DEVICE):
    """Angle of the analytic signal, in (-pi, pi]."""
    return torch.angle(hilbert(x, axis=axis, device=device))


def plv_matrix(phases, device=config.DEFAULT_DEVICE):
    """Phase-locking value matrix from (nchan, ntrials) phases at one time:
    PLV[i, j] = |mean_trials exp(i (phi_i - phi_j))| (reference
    ``fit_gpcsd_baseline.py:311-322``)."""
    phases = config.on_device(phases, device)
    z = torch.exp(1j * phases)  # (nchan, ntrials)
    return torch.abs(z @ z.conj().T / phases.shape[1])


def periodogram(x, fs=1.0, axis=-1, detrend=True, device=config.DEFAULT_DEVICE):
    """One-sided periodogram (``scipy.signal.periodogram`` semantics, boxcar
    window, density scaling).  Returns (freqs, pxx) tensors on ``device``."""
    x = torch.movedim(config.on_device(x, device), axis, -1)
    n = x.shape[-1]
    if detrend:
        x = x - torch.mean(x, dim=-1, keepdim=True)
    pxx = torch.square(torch.abs(torch.fft.rfft(x, dim=-1))) / (fs * n)
    scale = np.full(pxx.shape[-1], 2.0)
    scale[0] = 1.0
    if n % 2 == 0:
        scale[-1] = 1.0
    pxx = pxx * torch.as_tensor(scale, device=x.device)
    freqs = torch.as_tensor(np.fft.rfftfreq(n, 1.0 / fs), device=x.device)
    return freqs, torch.movedim(pxx, -1, axis)
