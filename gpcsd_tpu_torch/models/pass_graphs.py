"""CUDA graphs of the batched log-joint pass, one set per row count.

A value+grad pass of ``log_prob`` or ``neg_log_joint`` issues a few hundred
small ops from Python on either side of its two ``eigh`` calls: the
parameter transform, the Gram and ``Kt`` builds and the whitening before
them; the clamps, ``D``, the log-determinant and the priors after them; and
the backward of each.  The card waits for the host to issue them.  Here
each side is a forward and a backward CUDA graph, replayed by one launch
each through an autograd node:

- the *inputs half*: ``u`` -> the spatial ``eigh``'s matrix and ``Kt``;
- the factorization, eager as without graphs: the temporal
  :func:`~gpcsd_tpu_torch.ops.kronlik.temporal_eigh` (the block-Jacobi
  kernel) and the spatial :func:`~gpcsd_tpu_torch.ops.kronlik.eigh_safe`
  (cuSOLVER, a host sync) in span ``gpcsd.kronlik.comp_eig_d``, and their
  regularized backward;
- the *factors half*: the eigenpairs and ``u`` -> ``D``, the whitened
  spatial basis (exact heteroscedastic path only), the log-determinant term
  and the prior term (recomputed from ``u``, so the half takes tensors only);
- eager again: :func:`~gpcsd_tpu_torch.ops.kronlik.quad_term` (its span, its
  kernel launches and their counts) and the few scalar ops that join the
  terms.

A set of graphs is keyed by the objective, the row count ``C`` (with the
dtype and device of ``u``) and the shape, dtype and device of ``Y``; the
model's fixed tensors are the owner's (one :class:`PassGraphs` per
:class:`~gpcsd_tpu_torch.models.core.ModelFns`).  ``Y`` enters no graph:
only its shape does (the trial count of the log-determinant term).  A key
runs eagerly the first time it is seen, is captured the second time (one
warm-up, in a memory pool the model's keys share) and replays after that; a one-off
batch (the Laplace Hessian's rows, a probe) never pays for a capture.  The
eager halves sit behind the same autograd boundary as the graphs and
differentiate the same way, so a pass gives the same bits either way.  At
most :data:`MAX_KEYS` keys are kept, the least recently used going first.
No capture starts while a ``torch.profiler`` runs: such a pass runs eagerly.

Graphs engage only inside
:func:`~gpcsd_tpu_torch.models.core.value_and_grad_rows` (:func:`engaged`),
for CUDA rows with grad enabled; value-only calls, the CPU, the shift stage
and the trial-sharded ``parallel/`` log-prob never reach them.  Counters
(:mod:`gpcsd_tpu_torch.utils.profiling`): ``graph.capture`` (passes that
captured a key, then replayed it), ``graph.replay`` (passes computed by
replays, those captures included), ``graph.eager`` (passes that could have
replayed but ran eagerly: a key's first sighting, or a capture put off
under a profiler).
"""

from __future__ import annotations

import contextlib
import functools
import math
from collections import OrderedDict

import torch
import torch.autograd.profiler as _autograd_profiler

from ..ops import kronlik
from ..utils.profiling import count, span

#: keys kept, the least recently used going first
MAX_KEYS = 16

#: whether the running pass may replay graphs (set by :func:`engaged`), and
#: whether it did; a module slot, as the callers' closures stand between
#: :func:`~gpcsd_tpu_torch.models.core.value_and_grad_rows` and the model
_pass = {"engaged": False, "replayed": False}
_SEEN_ONCE = object()


@contextlib.contextmanager
def engaged():
    """Let the log-joint calls inside the block replay graphs.  Yields a
    dict whose ``"replayed"`` says, after the block, whether any did."""
    _pass.update(engaged=True, replayed=False)
    try:
        yield _pass
    finally:
        _pass["engaged"] = False


def eligible(u) -> bool:
    """Whether a log-joint call on rows ``u`` may run through graphs: inside
    :func:`engaged`, on CUDA, with grad enabled and ``u`` requiring it."""
    return (_pass["engaged"] and u.is_cuda and u.ndim == 2
            and torch.is_grad_enabled() and u.requires_grad)


class PassGraphs:
    """The graphed halves of one model's log-joint pass and their cache.

    :param inputs_half: ``u -> (spatial eigh input, Kt)``
    :param factors_half: ``(objective, ntrials, lam_t, lam_s, u, qs=None)
        -> (d, logdet term, prior term[, whitened qs])``, the whitened ``qs``
        given and returned on the exact heteroscedastic path only
    :param whitened: whether the model takes that path
    :param fixed_log_prior: the constant prior mass ``neg_log_joint`` adds
    """

    def __init__(self, inputs_half, factors_half, whitened: bool, fixed_log_prior: float):
        self.inputs_half = inputs_half
        self.factors_half = factors_half
        self.whitened = whitened
        self.fixed_log_prior = fixed_log_prior
        self._cache: OrderedDict = OrderedDict()
        self._stream = self._pool = None

    def __len__(self):
        return len(self._cache)

    def run(self, objective: str, u, Y):
        """The objective's ``(C,)`` values at the rows ``u`` through the two
        halves, replayed or eager, or None where the call is not
        :func:`eligible` (the caller's own eager path then runs)."""
        if not eligible(u):
            return None
        return self.evaluate(objective, u, Y, self._halves(objective, u, Y))

    def plain_halves(self, objective: str, Y):
        """The two halves as plain functions of tensors, for the objective
        and the trials' shape."""
        return (self.inputs_half,
                functools.partial(self.factors_half, objective, math.prod(Y.shape[:-2])))

    def _halves(self, objective: str, u, Y):
        """The ``(inputs half, factors half)`` for this pass, replayed from
        graphs or, where the key has no graphs, run eagerly behind the same
        autograd boundary (:class:`_EagerHalf`); counts the pass."""
        key = (objective, tuple(u.shape), u.dtype, u.device, tuple(Y.shape), Y.dtype, Y.device)
        entry = self._cache.pop(key, None)
        if entry is None or (entry is _SEEN_ONCE and _autograd_profiler._is_profiler_enabled):
            self._cache[key] = _SEEN_ONCE
            while len(self._cache) > MAX_KEYS:
                self._cache.popitem(last=False)
            count("graph.eager")
            return tuple(functools.partial(_EagerHalf.apply, half)
                         for half in self.plain_halves(objective, Y))
        if entry is _SEEN_ONCE:
            entry = self._capture(objective, u, Y)
            count("graph.capture")
        self._cache[key] = entry
        count("graph.replay")
        _pass["replayed"] = True
        return entry

    def _capture(self, objective, u, Y):
        """Both halves' graphs for one key, captured in the order they
        replay: forward A, forward B, backward B, backward A (so that no
        replay of the pass overwrites memory a later one of it reads).

        All keys share one memory pool and one capture stream (the
        allocator reuses a freed block only on the stream it was freed on).
        A key's replays need no memory to keep its contents from one pass
        to the next: a pass copies the inputs in, its replays write all
        they read after that, the results leave it as copies, and passes
        run one at a time.  So a key keeps only its static buffers; its
        saved activations go back to the pool for any later capture.  The
        graphs then hold about one pass's working set of the largest key,
        where a pool a key held their sum (a twenty-restart fit of the
        Neuropixels model ran the card out of memory that way).  A pool
        lives while a graph captured into it does: with none left in the
        cache, the next capture takes a new one."""
        rows, (nx, nt) = u.shape[0], Y.shape[-2:]
        half_a, half_b = self.plain_halves(objective, Y)
        if self._stream is None:
            self._stream = torch.cuda.Stream(u.device)
        if all(entry is _SEEN_ONCE for entry in self._cache.values()):
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(u.device))
        with torch.cuda.stream(side):
            like = dict(dtype=u.dtype, device=u.device)
            sample_b = [torch.ones(rows, nt, **like), torch.ones(rows, nx, **like), u.detach().clone()]
            if self.whitened:
                sample_b.append(torch.eye(nx, **like).expand(rows, nx, nx).clone())
            halves = [_HalfGraphs(half_a, [u.detach().clone()]),
                      _HalfGraphs(half_b, sample_b)]
            for half in halves:
                half.warm_up()
            for half in halves:
                half.capture_forward(self._pool)
            for half in reversed(halves):
                half.capture_backward(self._pool)
        torch.cuda.current_stream(u.device).wait_stream(side)
        return tuple(half.apply for half in halves)

    def evaluate(self, objective: str, u, Y, halves=None):
        """The objective's ``(C,)`` values at the rows ``u`` through the two
        halves (default: the plain ones, as a test runs them) around the
        eager ``eigh`` calls and quadratic term."""
        half_a, half_b = halves or self.plain_halves(objective, Y)
        eigh_in, Kt = half_a(u)
        with span("gpcsd.kronlik.comp_eig_d"):
            lam_t, qt = kronlik.temporal_eigh(Kt)
            lam_s, qs = kronlik.eigh_safe(eigh_in)
        if self.whitened:
            d, logdet, prior, qs = half_b(lam_t, lam_s, u, qs)
        else:
            d, logdet, prior = half_b(lam_t, lam_s, u)
        # quad_term reads qs, qt and d alone
        factors = kronlik.KronFactors(qs=qs, qt=qt, lam_s=None, lam_t=None, d=d,
                                      logdet_offset=None)
        loglik = -0.5 * (logdet + kronlik.quad_term(factors, Y))
        if objective == "log_prob":
            return loglik + prior
        return -(loglik + prior + self.fixed_log_prior)


def _vjp(outputs, inputs, cotangents):
    """The gradients of ``sum_k <outputs_k, cotangents_k>`` with respect to
    ``inputs``.  One ``autograd.grad`` of a scalar, without ``grad_outputs``:
    given those, ``autograd.grad`` checks their shapes through
    ``torch.fx.experimental.symbolic_shapes``, whose first import (sympy)
    takes seconds.  The cotangents reach each output's backward exactly, as
    ``1 * cotangent``."""
    total = sum((o * c).sum() for o, c in zip(outputs, cotangents))
    return torch.autograd.grad(total, inputs)


class _HalfGraphs:
    """One half's forward and backward CUDA graphs and their static buffers:
    ``inputs`` (copied in at each replay), ``outputs``, the cotangents of
    the outputs and the gradients of the inputs."""

    def __init__(self, fn, inputs):
        self.fn = fn
        self.inputs = [x.requires_grad_() for x in inputs]

    def warm_up(self):
        outputs = self.fn(*self.inputs)
        _vjp(outputs, self.inputs, outputs)

    def capture_forward(self, pool):
        self.forward_graph = torch.cuda.CUDAGraph()
        self.forward_graph.capture_begin(pool=pool)
        self.outputs = self.fn(*self.inputs)
        self.forward_graph.capture_end()

    def capture_backward(self, pool):
        self.cotangents = [torch.empty_like(o) for o in self.outputs]
        self.backward_graph = torch.cuda.CUDAGraph()

        def capture():
            self.backward_graph.capture_begin(pool=pool)
            self.grads = _vjp(self.outputs, self.inputs, self.cotangents)
            self.backward_graph.capture_end()

        _in_backward(capture, self.inputs[0].device)
        # the saved activations go back to the pool (PassGraphs._capture)
        self.outputs = [o.detach() for o in self.outputs]

    def apply(self, *inputs):
        """The half on ``inputs`` by replays, differentiable."""
        return _Replay.apply(self, *inputs)


def _in_backward(body, device):
    """Run ``body`` inside an autograd backward, where a pass runs a half's
    vector-Jacobian product (:class:`_EagerHalf`): an ``autograd.grad``
    called there is reentrant, and the engine orders a reentrant backward's
    gradient sums otherwise than a top-level one's (the last bit of a
    gradient that three terms add to)."""
    x = torch.zeros((), device=device, requires_grad=True)
    torch.autograd.grad(_InBackward.apply(body, x), x)


class _InBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, body, x):
        ctx.body = body
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            ctx.body()
        return None, grad


class _EagerHalf(torch.autograd.Function):
    """A half run eagerly as one autograd node whose backward is the same
    vector-Jacobian product (:func:`_vjp`) that the half's backward graph
    replays: a pass gives the same bits eager and replayed, whatever the
    cache has seen (a resumed fit or chain repeats the uninterrupted one)."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        with torch.enable_grad():
            ctx.inputs = [x.detach().requires_grad_() for x in inputs]
            ctx.outputs = fn(*ctx.inputs)
        return tuple(o.detach() for o in ctx.outputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cotangents):
        with torch.enable_grad():
            return (None,) + _vjp(ctx.outputs, ctx.inputs, cotangents)


class _Replay(torch.autograd.Function):
    """A half's forward graph as an autograd node whose backward is the
    half's backward graph.  Outputs and gradients are the graphs' buffers,
    valid until the next replay of the same half."""

    @staticmethod
    def forward(ctx, half, *inputs):
        ctx.half = half
        for static, x in zip(half.inputs, inputs):
            if static.data_ptr() != x.data_ptr():
                static.copy_(x)
        half.forward_graph.replay()
        return tuple(o.detach() for o in half.outputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cotangents):
        half = ctx.half
        for static, c in zip(half.cotangents, cotangents):
            if static.data_ptr() != c.data_ptr():
                static.copy_(c)
        half.backward_graph.replay()
        return (None,) + tuple(g.detach() for g in half.grads)
