"""Named-parameter DSL: supports, bijectors, packing.

Counterpart of ``gpcsd_tpu.models.params``, with the same packing order so
that a flat unconstrained vector from the JAX package (e.g. banked NUTS
draws) means the same point here.  The bijector is the reference's log
transform including its ``/100`` scaling for R and the spatial lengthscale
(``gpcsd1d.py:138-139,161-174``):

    constrained theta = exp(u) * scale,  u unconstrained

Box bounds (reference L-BFGS-B bounds, ``gpcsd1d.py:137-151``) live in
u-space as ``[log(lo/scale), log(hi/scale)]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import DTYPE
from .priors import Prior


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One named (possibly vector) positive parameter."""

    prior: Tuple[Prior, ...] | Prior
    lo: np.ndarray  # broadcastable to shape
    hi: np.ndarray
    scale: float = 1.0
    size: int = 1  # number of scalar components

    @property
    def priors(self) -> Tuple[Prior, ...]:
        if isinstance(self.prior, tuple):
            return self.prior
        return (self.prior,) * self.size


class ParamSet:
    """Ordered collection of :class:`ParamSpec` with pack/unpack utilities."""

    #: Positive floor on constrained values, as in the JAX package (where
    #: it keeps TPU double-f32 ``exp`` underflow from turning a prior term
    #: into -inf).  Kept so both packages return the same density at every
    #: point.
    VALUE_FLOOR = 1e-35

    def __init__(self, specs: Dict[str, ParamSpec]):
        self.specs = dict(specs)
        self.names = list(specs.keys())
        self._offsets = {}
        off = 0
        for name in self.names:
            self._offsets[name] = (off, off + specs[name].size)
            off += specs[name].size
        self.dim = off

    def names_flat(self):
        """Per-scalar-component names in packing order (vector params expand
        to ``name[i]``)."""
        out = []
        for name in self.names:
            s = self.specs[name]
            if s.size == 1:
                out.append(name)
            else:
                out.extend(f"{name}[{i}]" for i in range(s.size))
        return out

    # -- packing ------------------------------------------------------------

    def pack(self, theta: Dict) -> torch.Tensor:
        """Named constrained values -> flat unconstrained vector (on the
        device of the values; numpy values go to the CPU)."""
        parts = []
        for name in self.names:
            v = torch.as_tensor(theta[name], dtype=DTYPE).reshape(-1)
            parts.append(torch.log(v / self.specs[name].scale))
        return torch.cat(parts)

    def unpack(self, u: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Flat unconstrained vector -> named constrained values."""
        out = {}
        for name in self.names:
            lo, hi = self._offsets[name]
            s = self.specs[name]
            v = torch.clamp(torch.exp(u[..., lo:hi]) * s.scale, min=self.VALUE_FLOOR)
            out[name] = v[..., 0] if s.size == 1 else v
        return out

    # -- densities ----------------------------------------------------------

    def log_prior(self, theta: Dict[str, torch.Tensor]):
        """Sum of (unnormalized) prior lpdfs over all components."""
        total = 0.0
        for name in self.names:
            s = self.specs[name]
            v = torch.atleast_1d(theta[name])
            for i, p in enumerate(s.priors):
                total = total + p.lpdf(v[..., i] if s.size > 1 else v[..., 0])
        return total

    def log_det_jacobian(self, u: torch.Tensor):
        """log |d theta / d u| for the exp bijector = sum(u) + sum(log scale)."""
        logscale = sum(np.log(self.specs[n].scale) * self.specs[n].size for n in self.names)
        return torch.sum(u, dim=-1) + logscale

    # -- bounds & sampling ---------------------------------------------------

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) box bounds in unconstrained space, each (dim,)."""
        lo = np.empty(self.dim)
        hi = np.empty(self.dim)
        for name in self.names:
            o0, o1 = self._offsets[name]
            s = self.specs[name]
            lo[o0:o1] = np.log(np.broadcast_to(s.lo, (s.size,)) / s.scale)
            hi[o0:o1] = np.log(np.broadcast_to(s.hi, (s.size,)) / s.scale)
        return lo, hi

    def sample(self, gen: np.random.Generator):
        """Draw constrained values (numpy) from the priors with ``gen``
        (restart initialization, mirroring ``gpcsd1d.py:194-208``)."""
        out = {}
        for name in self.names:
            s = self.specs[name]
            v = np.array([float(p.sample(gen)) for p in s.priors])
            out[name] = v[0] if s.size == 1 else v
        return out

    def clip_to_bounds(self, u: torch.Tensor):
        lo, hi = self.bounds()
        lo = torch.as_tensor(lo, dtype=u.dtype, device=u.device)
        hi = torch.as_tensor(hi, dtype=u.dtype, device=u.device)
        return torch.clamp(u, lo, hi)
