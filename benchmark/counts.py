"""The benchmark's own counts of operations and bytes, and the card's peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s in FP64 on the tensor cores, 3.35 TB/s of HBM3.

The counts are frozen conventions, computed from shapes alone, whatever the
program's implementation does:

- the quadratic term at ``(nx, nt, ntrials)``: its two GEMMs per trial,
  ``Qs^T Y_b`` (``2 nx^2 nt``) and ``(.) Qt`` (``2 nx nt^2``); bytes: ``Y``,
  ``Qt``, ``Qs`` and ``dinv`` read once and the scalar written, float64;
- a symmetric eigendecomposition with vectors of order ``n``: ``9 n^3``;
  its backward (three n x n GEMMs): ``6 n^3``;
- the spatial covariance ``A Kgl A^T`` over ``m`` quadrature nodes:
  ``2 nx m^2 + 2 nx^2 m``;
- one value-and-gradient row evaluation of the log-joint: forward = the
  spatial covariance's GEMMs + ``eigh`` of ``Kt`` and of ``Ks`` + the
  quadratic term; backward = twice the spatial GEMMs + the two ``eigh``
  backwards + twice the quadratic term (gradients to ``Qs`` and ``Qt``).
  Elementwise work is not counted.
"""

from __future__ import annotations

import math

PEAK_FP64_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
F64_BYTES = 8


def quadform_flops(nx, nt, ntrials):
    return 2 * nx * nx * nt * ntrials + 2 * nx * nt * nt * ntrials


def quadform_bytes(nx, nt, ntrials):
    return F64_BYTES * (ntrials * nx * nt + nt * nt + nx * nx + nx * nt + 1)


def quadform_bound_s(nx, nt, ntrials):
    """Least time of the quadratic term on the card: the larger of its
    operations at the FP64 peak and its bytes at the HBM peak."""
    return max(quadform_flops(nx, nt, ntrials) / PEAK_FP64_FLOPS,
               quadform_bytes(nx, nt, ntrials) / PEAK_HBM_BYTES)


def eigh_flops(n):
    return 9 * n ** 3


def eigh_backward_flops(n):
    return 6 * n ** 3


def spatial_gram_flops(nx, nodes):
    return 2 * nx * nodes * nodes + 2 * nx * nx * nodes


def quadrature_nodes(cfg):
    """Nodes of the configuration's quadrature rule (1D: ``ngl``; 2D: the product)."""
    return math.prod(cfg["ngl"]) if isinstance(cfg["ngl"], list) else cfg["ngl"]


def shape(cfg):
    """``(nx, nt, ntrials)`` of a configuration."""
    return cfg["nx"], cfg["nt"], cfg["ntrials"]


def row_eval_flops(cfg):
    """Operations of one value-and-gradient row evaluation (see the module)."""
    nx, nt, ntrials = shape(cfg)
    gram = spatial_gram_flops(nx, quadrature_nodes(cfg))
    quad = quadform_flops(nx, nt, ntrials)
    forward = gram + eigh_flops(nt) + eigh_flops(nx) + quad
    backward = 2 * gram + eigh_backward_flops(nt) + eigh_backward_flops(nx) + 2 * quad
    return forward + backward
