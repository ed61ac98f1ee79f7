"""Priors over GPCSD hyperparameters, counterpart of ``gpcsd_tpu.models.priors``.

Parity targets: ``GPCSDInvGammaPrior`` and ``GPCSDHalfNormalPrior`` in the
reference ``priors.py:14-51``, including the *unnormalized* log-densities
and the InvGamma ``set_params`` heuristic.  ``log_normalizer`` gives the
dropped constant.  ``lpdf`` works on tensors (and floats); ``sample``
draws from an explicit ``numpy.random.Generator``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from scipy.special import gammaln

from ..config import DTYPE


def _tensor(x):
    return torch.as_tensor(x, dtype=DTYPE)


@dataclasses.dataclass(frozen=True)
class Prior:
    def lpdf(self, x):
        raise NotImplementedError

    def sample(self, gen: np.random.Generator, shape=()):
        raise NotImplementedError

    def log_normalizer(self) -> float:
        """log of the dropped normalization constant (lpdf + this = true lpdf)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class InvGamma(Prior):
    """Inverse-gamma prior; unnormalized lpdf = -(alpha+1) log x - beta/x."""

    alpha: float = 1.0
    beta: float = 1.0

    def lpdf(self, x):
        x = _tensor(x)
        pos = x > 0
        val = -(self.alpha + 1.0) * torch.log(torch.where(pos, x, 1.0)) - self.beta / x
        return torch.where(pos, val, -torch.inf)

    def log_normalizer(self) -> float:
        return self.alpha * math.log(self.beta) - float(gammaln(self.alpha))

    def sample(self, gen, shape=()):
        # X ~ InvGamma(a, b)  <=>  X = b / Gamma(a, 1)
        return self.beta / gen.gamma(self.alpha, size=shape)

    @staticmethod
    def from_interval(l, u):
        """Reference ``set_params`` heuristic (``priors.py:30-32``):
        alpha = 2 + 9((l+u)/(u-l))^2, beta = (alpha-1)(l+u)/2.  A degenerate
        interval (u <= l) raises instead of dividing by zero."""
        if not u > l:
            raise ValueError(f"InvGamma.from_interval needs u > l, got l={l!r}, u={u!r}")
        alpha = 2.0 + 9.0 * ((l + u) / (u - l)) ** 2
        beta = 0.5 * (alpha - 1.0) * (l + u)
        return InvGamma(alpha=float(alpha), beta=float(beta))

    def __str__(self):
        return "InvGamma(%0.2f, %0.2f)" % (self.alpha, self.beta)


@dataclasses.dataclass(frozen=True)
class HalfNormal(Prior):
    """Half-normal prior; unnormalized lpdf = -0.5 (x/sd)^2 for x > 0."""

    sd: float = 1.0

    def lpdf(self, x):
        x = _tensor(x)
        return torch.where(x > 0, -0.5 * torch.square(x / self.sd), -torch.inf)

    def log_normalizer(self) -> float:
        return 0.5 * math.log(2.0 / math.pi) - math.log(self.sd)

    def sample(self, gen, shape=()):
        return np.abs(gen.standard_normal(size=shape)) * self.sd

    def __str__(self):
        return "HalfNormal(%0.2f)" % (self.sd,)


@dataclasses.dataclass(frozen=True)
class Normal(Prior):
    """Normal prior (e.g. per-trial time-shift regularization, reference
    ``auditory_lfp/fit_mean_function.py:306-311``)."""

    mu: float = 0.0
    sd: float = 1.0

    def lpdf(self, x):
        return -0.5 * torch.square((_tensor(x) - self.mu) / self.sd)

    def log_normalizer(self) -> float:
        return -0.5 * math.log(2.0 * math.pi) - math.log(self.sd)

    def sample(self, gen, shape=()):
        return self.mu + gen.standard_normal(size=shape) * self.sd

    def __str__(self):
        return "Normal(%0.2f, %0.2f)" % (self.mu, self.sd)
