"""A plain functional Adam over parameter lists, the port's copy of the JAX
package's ``optim/optimizers.py:adam``.

``torch.optim.Adam`` is not used: it rounds ``sqrt(v) / sqrt(1 - b2^t)``
in another order than the reference's ``sqrt(v / (1 - b2^t))`` and keeps
its moments out of reach, while carrying state across from the reference
needs them.  Here the moments are an :class:`AdamState` the caller holds,
and each update keeps the reference's operation order:
``m*b1 + g*(1-b1)``, ``v*b2 + g*g*(1-b2)``, bias correction with the step
count as a float, ``p - lr * (mhat / (sqrt(vhat) + eps))``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import torch


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


def adam(lr: float = 2e-4, b1: float = 0.5, b2: float = 0.9,
         eps: float = 1e-8) -> Optimizer:
    """Adam with CTGAN's defaults (lr 2e-4, betas (0.5, 0.9)).

    ``update`` writes the new parameter values into ``params`` in place
    (they are a module's parameters, so the module sees them without a
    copy) and returns the new moments; it records no autograd graph."""

    def init(params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState([torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params], 0)

    @torch.no_grad()
    def update(grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor]) -> AdamState:
        count = state.count + 1
        dev = params[0].device if params else "cpu"
        # float32 tensors on the device, not Python floats: a division by
        # a host scalar may run as a multiplication by its reciprocal
        c = torch.full((), float(count), dtype=torch.float32, device=dev)
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)
        mus, nus = [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            gf = g.float()
            mf = m * b1 + gf * (1 - b1)
            vf = v * b2 + gf * gf * (1 - b2)
            delta = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
            p.copy_(p - lr * delta)
            mus.append(mf)
            nus.append(vf)
        return AdamState(mus, nus, count)

    return Optimizer(init, update)
