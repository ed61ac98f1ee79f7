"""Amplitude reparameterization for the GPCSD hyperparameter posterior.

Counterpart of ``gpcsd_tpu.models.reparam``.  The posterior's hard
direction at the paper configuration is the forward-amplitude degeneracy:
``R`` rescales the quadrature operator's gain while the temporal sigma2's
rescale CSD variance, so total LFP signal power is nearly constant along a
CURVED ridge that no constant linear whitening unbends.  This module samples
coordinates in which the tightly-identified quantity is an axis:

    v_P = log( tr(Ks(R, ell)) / nx ) + logsumexp_k( log sigma2_k )
    v_dk = log sigma2_k - log sigma2_0         (k = 1..K-1)
    v_j = u_j                                  (every other coordinate)

``tr(Ks)/nx`` is the mean per-channel LFP-space signal variance implied by
UNIT total temporal sigma2 through the model's own quadrature amplitude
convention, so ``exp(v_P)`` is the mean signal variance per channel.  The
map is a closed-form bijection: given (v_R, v_ell), ``g = log(tr Ks / nx)``
is recomputed forward and the sigma2 logs are recovered by a softmax split
of ``v_P - g`` over the ratio coordinates.

The Jacobian is UNIMODULAR (|det| = 1): ordering coordinates as
(..., v_P, v_d1..v_dK-1), the block over (log sigma2_0..K-1) is
[[r_0..r_K-1 (softmax weights, sum 1)], [-1, 1, 0..], [-1, 0, 1, ..]] with
determinant 1, and the dependence of v_P on (u_R, u_ell) is
block-triangular.  So ``log_prob_v(v) = log_prob_u(T^{-1}(v))`` with NO
density correction, for any number of temporal components.

Both maps take a vector ``(dim,)`` or rows ``(C, dim)``, as the batched
``log_prob`` does, and are assembled out of place so that autograd follows
them.  ``wrap_log_prob_aux`` of the JAX class has no counterpart: this
package threads no eigenbasis along trajectories.
"""

from __future__ import annotations

import torch


class AmplitudeReparam:
    """Bijection ``v = T(u)`` straightening the forward-amplitude ridge.

    :param fns: a :class:`gpcsd_tpu_torch.models.core.ModelFns` (supplies
        ``param_set`` for coordinate offsets and ``build_ks`` for the trace
        gain).
    """

    def __init__(self, fns):
        self.fns = fns
        ps = fns.param_set
        self.dim = ps.dim
        self._s_offsets = []
        k = 0
        while f"tm{k}_sigma2" in ps.specs:
            o0, o1 = ps._offsets[f"tm{k}_sigma2"]
            if o1 - o0 != 1:
                raise ValueError(f"tm{k}_sigma2 is not a scalar parameter")
            self._s_offsets.append(o0)
            k += 1
        if not self._s_offsets:
            raise ValueError("model has no temporal sigma2 parameters")
        self.n_sigma2 = len(self._s_offsets)

    def _log_gain(self, u):
        """``log(tr Ks(R, ell) / nx)``: mean per-channel LFP signal variance
        at unit total temporal sigma2 (differentiable); one value per row."""
        theta = self.fns.full_theta(self.fns.param_set.unpack(u))
        Ks = self.fns.build_ks(theta)
        trace = torch.diagonal(Ks, dim1=-2, dim2=-1).sum(-1)
        return torch.log(trace / Ks.shape[-1])

    def _with_slots(self, x, slots):
        """``x`` with the sigma2 coordinates replaced by ``slots`` (one
        ``x.shape[:-1]`` tensor per temporal component), out of place."""
        cols = list(torch.unbind(x, dim=-1))
        for o, s in zip(self._s_offsets, slots):
            cols[o] = s
        return torch.stack(cols, dim=-1)

    def forward(self, u):
        """u -> v.  Coordinate slots are reused: sigma2_0's slot carries
        v_P; sigma2_k's slot (k >= 1) carries the log-ratio v_dk."""
        s = torch.stack([u[..., o] for o in self._s_offsets], dim=-1)
        v_P = torch.logsumexp(s, dim=-1) + self._log_gain(u)
        return self._with_slots(
            u, [v_P] + [s[..., k] - s[..., 0] for k in range(1, self.n_sigma2)]
        )

    def inverse(self, v):
        """v -> u (closed form: forward gain + softmax split)."""
        g = self._log_gain(v)  # only reads R/ell slots, untouched by T
        v_P = v[..., self._s_offsets[0]]
        diffs = [v[..., self._s_offsets[k]] for k in range(1, self.n_sigma2)]
        # log-softmax over (0, d1, .., dK-1): s_k = S + log r_k with
        # r = softmax, S = total log sigma2
        zs = torch.stack([torch.zeros_like(v_P)] + diffs, dim=-1)
        log_r = zs - torch.logsumexp(zs, dim=-1, keepdim=True)
        S = v_P - g
        return self._with_slots(v, [S + log_r[..., k] for k in range(self.n_sigma2)])

    # log|det dT/du| == 0 (unimodular; see module docstring)

    def wrap_log_prob(self, log_prob):
        """``log_prob_u -> log_prob_v`` (no Jacobian correction)."""

        def log_prob_v(v, *args, **kwargs):
            return log_prob(self.inverse(v), *args, **kwargs)

        return log_prob_v
