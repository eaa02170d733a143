"""The collective federated round, FedProx and partial participation, the
port's copy of the JAX package's ``core/fedavg.py``.

``make_federated_round`` is the model-agnostic round of one client on one
rank of a ``torch.distributed`` process group (the reference's slice of a
mesh axis): the local steps of a caller's ``step_fn(state, batch) ->
(state, metrics)``, then ONE weighted all-reduce of the aggregated part of
the state (:func:`repro_torch.core.aggregation.psum_weighted`; a lens says
which part: parameters, optimizer moments stay local).
``shard_map_federated_round`` hands each rank its slice of the client
axis.  ``fedprox_wrap``, ``sample_participation`` and
``sample_client_weights`` serve the degraded federation.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .aggregation import psum_weighted


def default_lens(state):
    """For states with ``.params``: aggregate the params, keep the rest."""
    return state.params


def default_merge(state, merged_params):
    return state._replace(params=merged_params)


def _step_slice(batches, e: int):
    """Step ``e`` of ``batches``: a tensor, or a tuple of tensors, with a
    leading local-steps axis."""
    if isinstance(batches, torch.Tensor):
        return batches[e]
    return tuple(x[e] for x in batches)


def make_federated_round(step_fn: Callable, *,
                         group: dist.ProcessGroup | None = None,
                         lens: Callable = default_lens,
                         merge: Callable = default_merge) -> Callable:
    """Returns ``round_fn(state, batches, weight) -> (state, metrics)``, run
    on every rank of ``group`` (default: the world) with that rank's
    client: the local steps over ``batches`` (a leading local-steps axis),
    metrics (a dict per step) stacked over the steps, then
    ``psum_weighted(lens(state), weight, group)`` and ``merge``.
    ``weight`` is this client's scalar weight; the weights sum to 1 over
    the group (softmax output)."""
    def round_fn(state, batches, weight):
        n_steps = (batches if isinstance(batches, torch.Tensor)
                   else batches[0]).shape[0]
        metrics = []
        for e in range(n_steps):
            state, m = step_fn(state, _step_slice(batches, e))
            metrics.append(m)
        merged = psum_weighted(lens(state), weight, group)
        return merge(state, merged), {k: torch.stack([m[k] for m in metrics])
                                      for k in metrics[0]}
    return round_fn


def shard_map_federated_round(step_fn: Callable, *,
                              group: dist.ProcessGroup | None = None,
                              lens: Callable = default_lens,
                              merge: Callable = default_merge) -> Callable:
    """:func:`make_federated_round` with the client axis handed out by
    rank: ``wrapped(state, batches, weights)`` takes ``batches`` with
    (clients, local_steps, ...) leading axes and the (P,) §4.2
    ``weights``, P the size of ``group``; rank r trains on ``batches[r]``
    with ``weights[r]``.  ``state`` is the same on every rank on entry
    (every client starts a round from the merged model) and again on exit
    (after the all-reduce).  The metrics come back (1, local_steps): this
    rank's row of the reference's (P, local_steps).  The reference's mesh
    and state specs become the process group."""
    round_fn = make_federated_round(step_fn, group=group, lens=lens,
                                    merge=merge)

    def wrapped(state, batches, weights):
        if weights.shape[0] != dist.get_world_size(group):
            raise ValueError(f"{weights.shape[0]} client weights for a "
                             f"group of {dist.get_world_size(group)} ranks")
        r = dist.get_rank(group)
        state, metrics = round_fn(state, _step_slice(batches, r), weights[r])
        return state, {k: v[None] for k, v in metrics.items()}
    return wrapped


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

