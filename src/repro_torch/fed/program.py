"""Federated global rounds, the port's copy of the JAX package's
``fed/program.py``.

One global round: every client's local round
(:meth:`repro_torch.synth.RoundEngine.clients_round`), the §4.2 weights,
ONE fused ``weighted_agg`` merge of generator and critic parameters
together (one per tier with ``n_edges``), and the merged model copied back
to every client.  ``run`` loops over rounds with the weights resolved once.

The reference lowers a round into one XLA program; here a round is a
sequence of launches on one stream with no host wait in it (metrics stay
on the device).  The faulted, traced, FedProx and DP renderings are not
ported (ROADMAP).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core.weighting import (quantity_only_weights, uniform_weights,
                              weights_from_divergence)
from ..gan.ctgan import CTGANConfig
from ..gan.trainer import GANState, StepNoise
from ..synth import RoundEngine, SamplerDraws, SamplerTables
from ..tabular.encoders import SpanInfo
from .merge import fused_weighted_merge, replicate, tiered_weighted_merge

WEIGHTINGS = ("fedtgan", "uniform", "quantity")


def resolve_weights(weighting: str, S: torch.Tensor,
                    n_rows: torch.Tensor) -> torch.Tensor:
    """The §4.2 weight vector: ``fedtgan`` = Fig.4 steps 1-4 on the
    divergence matrix, ``uniform`` = vanilla FL, ``quantity`` = the
    Fed\\SW ablation.  ``S`` is read only under ``fedtgan``."""
    if weighting == "fedtgan":
        return weights_from_divergence(S, n_rows)
    if weighting == "quantity":
        return quantity_only_weights(n_rows)
    if weighting == "uniform":
        return uniform_weights(n_rows.shape[0], device=n_rows.device)
    raise ValueError(f"unknown weighting {weighting!r}; options: {WEIGHTINGS}")


class FederatedProgram:
    """Federated execution for one table schema: local rounds, weighting,
    the fused merge and the redistribution."""

    def __init__(self, cfg: CTGANConfig, spans: Sequence[SpanInfo],
                 cond_spans: Sequence[SpanInfo], *, batch: int,
                 local_steps: int, weighting: str = "fedtgan",
                 n_edges: int | None = None):
        if weighting not in WEIGHTINGS:
            raise ValueError(f"unknown weighting {weighting!r}; "
                             f"options: {WEIGHTINGS}")
        if n_edges is not None and n_edges < 1:
            raise ValueError(f"n_edges must be >= 1, got {n_edges}")
        self.cfg = cfg
        self.weighting = weighting
        self.n_edges = n_edges
        self.engine = RoundEngine(cfg, tuple(spans), tuple(cond_spans),
                                  batch=batch, local_steps=local_steps)

    def merge_states(self, states: Sequence[GANState],
                     w: torch.Tensor) -> Sequence[GANState]:
        """Federator merge and redistribution: every client's generator and
        critic parameters in ONE ``weighted_agg`` dispatch (one per tier
        with ``n_edges``), then copied back into every client."""
        trees = [s.params() for s in states]
        if self.n_edges is None:
            merged = fused_weighted_merge(trees, w)
        else:
            merged = tiered_weighted_merge(trees, w, self.n_edges)
        replicate(merged, trees)
        return states

    def weighted_round(self, states: Sequence[GANState],
                       tables: Sequence[SamplerTables], w: torch.Tensor, *,
                       draws: Sequence[SamplerDraws] | None = None,
                       noise: Sequence[Sequence[StepNoise]] | None = None):
        """One global round given resolved weights; ``draws`` and ``noise``
        inject every client's draws (see :meth:`RoundEngine.
        clients_round`).  Returns (states, metrics (clients, steps))."""
        states, metrics = self.engine.clients_round(states, tables,
                                                    draws=draws, noise=noise)
        return self.merge_states(states, w), metrics

    def global_round(self, states: Sequence[GANState],
                     tables: Sequence[SamplerTables], S: torch.Tensor,
                     n_rows: torch.Tensor, **inject):
        """One global round with the §4.2 weights resolved from the
        divergence matrix."""
        w = resolve_weights(self.weighting, S, n_rows)
        return self.weighted_round(states, tables, w, **inject)

    def run(self, states: Sequence[GANState], tables: Sequence[SamplerTables],
            S: torch.Tensor, n_rows: torch.Tensor, rounds: int, *,
            on_round: Callable | None = None):
        """``rounds`` global rounds, the weights resolved once.
        ``on_round(r, states, metrics)`` is called after round r's merge.
        Returns (states, metrics stacked (rounds, clients, steps))."""
        w = resolve_weights(self.weighting, S, n_rows)
        out = []
        for r in range(rounds):
            states, m = self.weighted_round(states, tables, w)
            if on_round is not None:
                on_round(r, states, m)
            out.append(m)
        return states, {k: torch.stack([m[k] for m in out])
                        for k in (out[0] if out else ())}
