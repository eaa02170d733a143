"""FedProx and partial participation, the port's copy of the parts of the
JAX package's ``core/fedavg.py`` that the degraded federation uses
(``fedprox_wrap``, ``sample_participation``, ``sample_client_weights``).
"""
from __future__ import annotations

from typing import Callable

import torch


def fedprox_wrap(step_fn: Callable, mu: float,
                 lens: Callable = lambda state: state.params()) -> Callable:
    """FedProx (Li et al. 2020): after every local step, pull the
    parameters ``lens(state)`` toward the round's global parameters,
    ``p - mu * (p - g)``, in place.

    The wrapped step takes ``(state, (batch, global_params), noise)``,
    ``global_params`` in ``lens`` order (see
    :meth:`repro_torch.synth.RoundEngine.local_round`'s ``aux``)."""
    def prox_step(state, batch_and_global, noise=None):
        batch, global_params = batch_and_global
        metrics = step_fn(state, batch, noise)
        with torch.no_grad():
            for p, g in zip(lens(state), global_params, strict=True):
                p.copy_(p - mu * (p - g.to(p.dtype)))
        return metrics
    return prox_step


def sample_participation(weights: torch.Tensor, fraction: float, *,
                         generator: torch.Generator | None = None
                         ) -> torch.Tensor:
    """The (P,) bool cohort of one round: each client kept with
    probability ``fraction``.  Only an EMPTY draw is rescued, by one
    client picked uniformly from ``generator`` (never a fixed client:
    forcing ``argmax(weights)`` would pin client 0's rate at 1 under tied
    weights).  Draws, in order: P keep uniforms, then the rescue index;
    nothing here waits for the device."""
    P = weights.shape[0]
    dev = weights.device
    keep = torch.rand(P, generator=generator, device=dev) < fraction
    rescue = (torch.arange(P, device=dev)
              == torch.randint(0, P, (), generator=generator, device=dev))
    return torch.where(torch.any(keep), keep, rescue)


def sample_client_weights(weights: torch.Tensor, fraction: float, *,
                          generator: torch.Generator | None = None
                          ) -> torch.Tensor:
    """:func:`sample_participation`'s cohort with the §4.2 weights
    renormalized over it; dropped clients get weight 0."""
    keep = sample_participation(weights, fraction, generator=generator)
    w = torch.where(keep, weights, 0.0)
    return w / torch.clamp(torch.sum(w), min=1e-12)

