"""Neuropixels NWB extraction utilities, numpy (and h5py for the files);
counterpart of ``gpcsd_tpu.io.nwb``.

Parity target: the reference ``neuropixels/extract_data.py``, h5py-based
extraction of mouse Neuropixels LFP (Zenodo 10.5281/zenodo.5150708):
channel -> (x, y) probe geometry (``:20-42``), CCF brain-region labeling of
channels from the spike file's unit structures (``:87-119``), flash-stimulus
trial epoching at 2.5 kHz (``:211-231``), and the per-probe pickle schema
consumed by ``fit_gpcsd2d.py`` (keys ``x``, ``t``, ``y``, ``fs``, ``roi``).
Host-side: the arrays it returns are numpy.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

#: Neuropixels Phase3a reference channels (no signal), reference ``:36-37``
REFERENCE_CHANNELS = (36, 75, 112, 151, 188, 227, 264, 303, 340, 379)

#: Region code per leading CCF-structure letter (reference ``:49``):
#: V = visual cortex, C = CA1/CA3, D = dentate gyrus, T = thalamus,
#: S = superior colliculus; 0 = unlabeled.
ROI_CODES = {"V": 1, "C": 2, "D": 3, "T": 4, "S": 5}

LFP_SAMPLE_RATE = 2500


def channel_location(channel: int):
    """Physical (x, y) microns of a Neuropixels channel relative to the tip,
    and whether it is a reference channel (checkerboard staggered columns)."""
    xlocations = (16, 48, 0, 32)
    is_reference = channel in REFERENCE_CHANNELS
    return (xlocations[channel % 4], float(np.floor(channel / 2) * 20)), is_reference


def probe_geometry(channels):
    """(n, 2) electrode coordinate array for a channel list, reference
    channels included (filter with :func:`channel_location` if needed)."""
    return np.array([channel_location(int(c))[0] for c in channels], dtype=np.float64)


def channel_region_labels(nwb_spikes, probe, n_channels=384):
    """Per-channel brain-region codes from spike-unit CCF structures.

    Reference ``extract_data.py:87-119``: for every sorted unit on the
    probe, read its ``ccf_structure`` string and stamp the unit's channel
    with the region code of the structure's leading letter (see
    :data:`ROI_CODES`).  Channels with no labeled unit stay 0.

    :param nwb_spikes: open h5py File of the ``.spikes.nwb`` companion
    :return: (n_channels,) int array of region codes
    """
    labels = np.zeros(n_channels, dtype=np.int64)
    proc = nwb_spikes["processing"][probe]
    units = np.asarray(proc["unit_list"][()]).reshape(-1)
    for unit in units:
        ut = proc["UnitTimes"][str(int(unit))]
        if "ccf_structure" not in ut:
            continue
        s = ut["ccf_structure"][()]
        if isinstance(s, bytes):
            s = s.decode("utf-8")
        s = str(s)
        if not s:
            continue
        code = ROI_CODES.get(s[0].upper())
        if code is not None:
            labels[int(np.asarray(ut["channel"][()]))] = code
    return labels


def epoch_trials(lfp_data, timestamps, trial_times, electrodes,
                 pre_s=0.5, n_samples=LFP_SAMPLE_RATE, gain_uv=0.195):
    """Epoch continuous LFP around stimulus onsets.

    :param lfp_data: (n_samples_total, n_channels) continuous recording
    :param timestamps: (n_samples_total,) seconds
    :param trial_times: (ntrials,) stimulus onset times, seconds
    :param electrodes: channel indices to keep
    :return: (nx, n_samples, ntrials) microvolt epochs and (n_samples,) t in
        seconds relative to onset
    """
    lfp_data = np.asarray(lfp_data)
    timestamps = np.asarray(timestamps).reshape(-1)
    electrodes = np.asarray(electrodes, dtype=int)
    ntrials = len(trial_times)
    nx = len(electrodes)
    out = np.zeros((nx, n_samples, ntrials))
    for trial, tt in enumerate(np.asarray(trial_times)):
        start = int(np.argmin(np.abs(timestamps - tt))) - int(n_samples * pre_s)
        start = max(0, min(start, lfp_data.shape[0] - n_samples))
        seg = lfp_data[start : start + n_samples, :][:, electrodes] * gain_uv
        out[:, :, trial] = seg.T
    t = np.linspace(-pre_s, n_samples / LFP_SAMPLE_RATE - pre_s, n_samples)
    return out, t


def extract_probe(lfp_nwb_path, spikes_nwb_path, probe, stim="flash_250ms_1",
                  out_path=None, region="V", roi_name=None):
    """Extract one probe's trial-epoched, region-selected LFP from the
    Zenodo NWB pair.

    Channels are labeled by brain region from the spike file's unit CCF
    structures (:func:`channel_region_labels`, reference ``:87-119``) and
    only the channels in ``region`` are kept — the reference saves the
    visual-cortex subset for the GPCSD2D + torus-graph stages
    (``extract_data.py:286-290``).

    Returns the reference pickle schema consumed by the Neuropixels
    workload: ``{'x': (nx,2), 't': (ns,1), 'y': (nx,ns,ntrials),
    'fs': 2500, 'roi': str, 'regions': (nx_all,) codes}``; optionally
    pickles it to ``out_path``.

    :param region: ROI letter to keep ('V', 'C', 'D', 'T', 'S'), or None
        to keep every recorded channel.
    :param roi_name: label stored under ``'roi'`` (e.g. 'V1' for probeC,
        'LM' for probeD, reference ``:45``); defaults to the region letter.
    """
    import h5py

    with h5py.File(lfp_nwb_path, "r") as nwb_lfp, h5py.File(spikes_nwb_path, "r") as nwb:
        series = nwb_lfp["acquisition"]["timeseries"][probe]
        lfp_data = series["data"]
        timestamps = series["timestamps"][()]
        electrodes = np.asarray(series["electrode_idx"][()]).reshape(-1)
        labels_all = channel_region_labels(nwb, probe)
        ch_labels = labels_all[electrodes]  # per recorded-row region code
        if region is not None:
            keep = np.flatnonzero(ch_labels == ROI_CODES[region.upper()])
        else:
            keep = np.arange(electrodes.size)
        trial_times = np.squeeze(
            nwb["stimulus"]["presentation"][stim]["timestamps"][()]
        )[:, 0]
        y, t = epoch_trials(lfp_data, timestamps, trial_times, keep)
        x = probe_geometry(electrodes[keep])
    out = {
        "x": x,
        "t": t.reshape(-1, 1),
        "y": y,
        "fs": LFP_SAMPLE_RATE,
        "roi": roi_name or (region if region is not None else "all"),
        "regions": ch_labels,
    }
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    return out
