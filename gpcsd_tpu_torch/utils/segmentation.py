"""Marker-based watershed segmentation (numpy, no skimage dependency),
copied from ``gpcsd_tpu.utils.segmentation``.

Used by the evoked-response pipeline to split the mean CSD image into
source/sink components (reference ``auditory_lfp/fit_mean_function.py:152-189``
uses ``skimage.segmentation.watershed``; the package does not depend on
scikit-image, so this is a self-contained priority-flood implementation).

Host-side preprocessing, not a hot path: runs once per fitted probe.
"""

from __future__ import annotations

import heapq

import numpy as np


def local_extrema_markers(img, threshold_abs, min_distance=3):
    """Marker image from local |img| maxima above a threshold.

    Returns (markers, n_markers): int array with 0 background and 1..K seeds.
    """
    img = np.asarray(img)
    a = np.abs(img)
    nx, nt = a.shape
    markers = np.zeros((nx, nt), dtype=np.int32)
    # candidate points sorted by magnitude, greedily accepted if far from
    # previously chosen seeds
    idx = np.argsort(a.ravel())[::-1]
    chosen = []
    k = 0
    for flat in idx:
        i, j = divmod(flat, nt)
        if a[i, j] < threshold_abs:
            break
        if all((i - ci) ** 2 + (j - cj) ** 2 >= min_distance**2 for ci, cj in chosen):
            k += 1
            markers[i, j] = k
            chosen.append((i, j))
    return markers, k


def watershed(elevation, markers, mask=None):
    """Priority-flood watershed.

    :param elevation: (nx, nt) surface; basins grow from low to high
    :param markers: (nx, nt) int seeds (0 = unlabeled)
    :param mask: optional bool array; False pixels stay label 0
    :return: (nx, nt) int labels
    """
    elevation = np.asarray(elevation, dtype=np.float64)
    markers = np.asarray(markers)
    nx, nt = elevation.shape
    labels = markers.copy().astype(np.int32)
    if mask is None:
        mask = np.ones((nx, nt), dtype=bool)
    heap = []
    counter = 0
    for i, j in zip(*np.nonzero(markers)):
        heapq.heappush(heap, (elevation[i, j], counter, i, j))
        counter += 1
    neigh = ((1, 0), (-1, 0), (0, 1), (0, -1))
    while heap:
        _, _, i, j = heapq.heappop(heap)
        lab = labels[i, j]
        for di, dj in neigh:
            ni, nj = i + di, j + dj
            if 0 <= ni < nx and 0 <= nj < nt and mask[ni, nj] and labels[ni, nj] == 0:
                labels[ni, nj] = lab
                heapq.heappush(heap, (elevation[ni, nj], counter, ni, nj))
                counter += 1
    return labels


def segment_csd(csd_mean, rel_threshold=0.3, min_distance=5):
    """Segment a mean-CSD image into source/sink components.

    Mirrors the reference recipe (``fit_mean_function.py:152-189``): seeds at
    strong local extrema, watershed on the negative magnitude so each basin
    captures one source or sink; pixels below the threshold stay background.

    :return: (labels, n_segments) — labels (nx, nt) with 0 = background.
    """
    csd_mean = np.asarray(csd_mean)
    thresh = rel_threshold * np.abs(csd_mean).max()
    markers, n = local_extrema_markers(csd_mean, thresh, min_distance)
    if n == 0:
        return np.zeros_like(csd_mean, dtype=np.int32), 0
    labels = watershed(-np.abs(csd_mean), markers, mask=np.abs(csd_mean) >= 0.3 * thresh)
    return labels, n
