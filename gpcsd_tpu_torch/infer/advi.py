"""ADVI: automatic differentiation variational inference (mean-field).

Counterpart of ``gpcsd_tpu.infer.advi``.  Operates on the same unconstrained
log-density as NUTS, so every model of this package gets ADVI for free.

q(u) = N(mu, diag(exp(2 rho))); reparameterized ELBO gradients; Adam with
optax's arithmetic.  The Monte-Carlo draws of a step are one call of the
batched ``log_prob`` on ``(n_mc, dim)`` rows and one backward.

Random numbers are explicit: the standard normals of every step are drawn
on the CPU from a ``torch.Generator`` (or passed in) and moved to the device
of ``u0``, so the card and the CPU see the same numbers.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class ADVIResult(NamedTuple):
    mu: torch.Tensor  # (dim,)
    rho: torch.Tensor  # (dim,) log std dev
    elbo_trace: torch.Tensor  # (num_steps,)

    def sample(self, gen: torch.Generator, n: int):
        """(n, dim) draws from q, the normals from ``gen`` on the CPU."""
        eps = torch.randn(n, self.mu.shape[-1], generator=gen, dtype=torch.float64)
        return self.mu + torch.exp(self.rho) * eps.to(device=self.mu.device, dtype=self.mu.dtype)


def elbo(log_prob: Callable, mu, rho, eps):
    """Monte-Carlo ELBO with the entropy term in closed form.

    :param log_prob: ``(n_mc, dim) -> (n_mc,)``, rows independent
    :param eps: (n_mc, dim) standard normals
    """
    dim = mu.shape[-1]
    lps = log_prob(mu + torch.exp(rho) * eps)
    entropy = torch.sum(rho) + 0.5 * dim * (1.0 + math.log(2.0 * math.pi))
    return torch.mean(lps) + entropy


def draw_eps(gen: torch.Generator, num_steps: int, n_mc: int, dim: int):
    """The (num_steps, n_mc, dim) float64 standard normals of a fit, on the CPU."""
    return torch.randn(num_steps, n_mc, dim, generator=gen, dtype=torch.float64)


def advi_fit(
    log_prob: Callable,
    u0,
    gen: torch.Generator | None = None,
    num_steps: int = 2000,
    n_mc: int = 8,
    learning_rate: float = 0.02,
    init_rho: float = -2.0,
    eps=None,
) -> ADVIResult:
    """Fit the mean-field approximation; returns means, log-stds, ELBO trace.

    :param log_prob: ``(n_mc, dim) -> (n_mc,)`` unnormalized posterior
        log-density on tensors, rows independent and differentiable
    :param u0: (dim,) start of ``mu``, on the device to run on
    :param gen: CPU generator for the steps' normals (:func:`draw_eps`),
        unless ``eps`` gives them
    :param eps: (num_steps, n_mc, dim) pre-drawn standard normals

    A step whose loss or gradient is not finite (q mass outside the prior's
    support early in the optimization) feeds Adam zero gradients: the
    moments decay and the parameters still move by the momentum, as in the
    JAX package.
    """
    u0 = torch.as_tensor(u0).detach()
    dtype, device = u0.dtype, u0.device
    if eps is None:
        eps = draw_eps(gen, num_steps, n_mc, u0.shape[-1])
    eps = torch.as_tensor(eps).to(device=device, dtype=dtype)
    if eps.shape != (num_steps, n_mc, u0.shape[-1]):
        raise ValueError(f"eps has shape {tuple(eps.shape)}, expected "
                         f"{(num_steps, n_mc, u0.shape[-1])}")
    params = [u0.clone().requires_grad_(True),
              torch.full_like(u0, init_rho).requires_grad_(True)]
    # optax.adam: b1 0.9, b2 0.999, eps 1e-8 outside the root, bias-corrected
    b1, b2, adam_eps = 0.9, 0.999, 1e-8
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    trace = torch.empty(num_steps, dtype=dtype, device=device)

    for k in range(num_steps):
        loss = -elbo(log_prob, params[0], params[1], eps[k])
        grads = torch.autograd.grad(loss, params)
        ok = torch.isfinite(loss)
        for g in grads:
            ok = ok & torch.isfinite(g).all()
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                g = torch.where(ok, g, 0.0)
                m[i] = b1 * m[i] + (1.0 - b1) * g
                v[i] = b2 * v[i] + (1.0 - b2) * torch.square(g)
                m_hat = m[i] / (1.0 - b1 ** (k + 1))
                v_hat = v[i] / (1.0 - b2 ** (k + 1))
                p -= learning_rate * m_hat / (torch.sqrt(v_hat) + adam_eps)
            trace[k] = -loss.detach()
    return ADVIResult(mu=params[0].detach(), rho=params[1].detach(), elbo_trace=trace)
