"""A plain functional Adam over parameter lists, the port's copy of the JAX
package's ``optim/optimizers.py``: ``adam`` with its schedules
(``constant_schedule``, ``cosine_schedule``) and ``clip_by_global_norm``,
and ``sgd`` with optional momentum.

``torch.optim.Adam`` is not used: it rounds ``sqrt(v) / sqrt(1 - b2^t)``
in another order than the reference's ``sqrt(v / (1 - b2^t))`` and keeps
its moments out of reach, while carrying state across from the reference
needs them.  Here the moments are an :class:`AdamState` the caller holds,
and each update keeps the reference's operation order in float32:
``m*b1 + g*(1-b1)``, ``v*b2 + g*g*(1-b2)``, bias correction with the step
count as a float, ``p - lr * (mhat / (sqrt(vhat) + eps) [+ wd * p])``;
moments and parameters are then rounded to their own dtypes (bfloat16
moments for bfloat16 parameters by default, as in the reference).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Sequence

import torch

# step (a 0-dim float32 tensor) -> learning rate (a 0-dim float32 tensor)
Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor: float = 0.0) -> Schedule:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a half cosine
    down to ``floor`` at ``total``, in float32 as the reference computes
    it."""
    def f(step):
        step = step.float()
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return f


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float) -> list[torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))``, the
    norm over all of them in float32, and round back to each gradient's
    dtype."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads]


class AdamState(NamedTuple):
    """First and second moments, one tensor per parameter, and the number
    of updates made."""
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Sequence[torch.Tensor]], AdamState]
    update: Callable[..., AdamState]
    # update(grads, state, params) -> new state; params are updated in place


def adam(lr: float | Schedule = 2e-4, b1: float = 0.5, b2: float = 0.9,
         eps: float = 1e-8, weight_decay: float = 0.0,
         moment_dtype: torch.dtype | None = None,
         max_grad_norm: float | None = None) -> Optimizer:
    """Adam/AdamW with CTGAN's defaults (lr 2e-4, betas (0.5, 0.9)).

    ``lr`` is a number or a :data:`Schedule` of the update count;
    ``moment_dtype=None`` keeps each moment in its parameter's dtype;
    ``max_grad_norm`` clips the gradients' global norm first.
    ``update`` writes the new parameter values into ``params`` in place
    (a module's parameters see them without a copy) and returns the new
    moments; it records no autograd graph."""

    def init(params: Sequence[torch.Tensor]) -> AdamState:
        def zeros(p):
            return torch.zeros_like(p, dtype=moment_dtype or p.dtype,
                                    requires_grad=False)
        return AdamState([zeros(p) for p in params],
                         [zeros(p) for p in params], 0)

    @torch.no_grad()
    def update(grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor]) -> AdamState:
        count = state.count + 1
        dev = params[0].device if params else "cpu"
        # float32 tensors on the device, not Python floats: a division by
        # a host scalar may run as a multiplication by its reciprocal
        c = torch.full((), float(count), dtype=torch.float32, device=dev)
        lr_t = lr(c) if callable(lr) else lr
        if max_grad_norm is not None:
            grads = clip_by_global_norm(grads, max_grad_norm)
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)
        mus, nus = [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            gf = g.float()
            mf = m.float() * b1 + gf * (1 - b1)
            vf = v.float() * b2 + gf * gf * (1 - b2)
            delta = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            p.copy_(p.float() - lr_t * delta)
            mus.append(mf.to(m.dtype))
            nus.append(vf.to(v.dtype))
        return AdamState(mus, nus, count)

    return Optimizer(init, update)


class SGDState(NamedTuple):
    """The momentum buffers (None without momentum), one tensor per
    parameter, and the number of updates made."""
    buf: list[torch.Tensor] | None
    count: int


def sgd(lr: float | Schedule = 1e-2, momentum: float = 0.0) -> Optimizer:
    """SGD, with heavy-ball momentum when ``momentum`` is not 0: ``buf =
    momentum * buf + g`` in the buffer's (the parameter's) dtype, then ``p
    - lr * buf`` in float32, rounded to the parameter's dtype.  ``update``
    writes into ``params`` in place, as :func:`adam`'s does."""

    def init(params: Sequence[torch.Tensor]) -> SGDState:
        if momentum:
            return SGDState([torch.zeros_like(p, requires_grad=False)
                             for p in params], 0)
        return SGDState(None, 0)

    @torch.no_grad()
    def update(grads: Sequence[torch.Tensor], state: SGDState,
               params: Sequence[torch.Tensor]) -> SGDState:
        count = state.count + 1
        dev = params[0].device if params else "cpu"
        c = torch.full((), float(count), dtype=torch.float32, device=dev)
        lr_t = lr(c) if callable(lr) else lr
        buf = state.buf
        if momentum:
            buf = [momentum * b + g.to(b.dtype) for b, g in zip(buf, grads)]
        for p, g in zip(params, buf if momentum else grads):
            p.copy_(p.float() - lr_t * g.float())
        return SGDState(buf, count)

    return Optimizer(init, update)
