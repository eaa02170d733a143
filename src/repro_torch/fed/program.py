"""Federated global rounds, the port's copy of the JAX package's
``fed/program.py``.

One global round: every client's local round
(:meth:`repro_torch.synth.RoundEngine.clients_round`), the §4.2 weights,
ONE fused ``weighted_agg`` merge of generator and critic parameters
together (one per tier with ``n_edges``), and the merged model copied back
to every client.  ``run`` loops over rounds with the weights resolved once.

``faulted_round`` is the degraded round: partial participation combined
with a :class:`~repro_torch.fed.faults.FaultPlan`'s slice, the local
rounds, the faults applied to the transmitted ``(P, D)`` stack, the
update guard, and the masked, renormalized merge in the same single
``weighted_agg`` launch (an all-masked round keeps the previous model).
``fedprox_mu > 0`` pulls every local step toward the round's global
parameters (:func:`repro_torch.core.fedavg.fedprox_wrap`).

``client_chunk`` is the reference's chunked client axis, checked as it
checks it; every kind of round (dense, traced, faulted, FedProx) gives
the dense round's result with it, bit for bit.

``dp`` (a :class:`~repro_torch.gan.dp.DPConfig`) makes every local step
DP-SGD (per-pack clip and Gaussian noise, :mod:`repro_torch.gan.dp`); the
round keeps its single merge launch, and FedProx wraps the DP step.
``traced_round`` / ``run_traced`` are the dense round that also returns
the transmitted ``(P, D)`` stack the merge read, for the privacy
recorder (:mod:`repro_torch.privacy`); the merge math is the same, so a
traced round is bit-identical to an untraced one.

The reference lowers a round into one XLA program; here a round is a
sequence of launches on one stream with no host wait in it (metrics stay
on the device).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core.fedavg import fedprox_wrap, sample_participation
from ..core.weighting import (quantity_only_weights, uniform_weights,
                              weights_from_divergence)
from ..gan.ctgan import CTGANConfig
from ..gan.dp import DPConfig
from ..gan.trainer import GANState, StepNoise, stack_metrics
from ..kernels import ops
from ..synth import RoundEngine, SamplerDraws, SamplerTables
from ..tabular.encoders import SpanInfo
from .faults import (DEFAULT_NORM_MULT, FaultPlan, UpdateGuard, apply_faults,
                     guard_ok, update_diagnostics)
from .merge import (flatten_stacked, replicate, tiered_weighted_merge_flat,
                    unflatten_merged)

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
    the fused merge and the redistribution, dense or degraded."""

    def __init__(self, cfg: CTGANConfig, spans: Sequence[SpanInfo],
                 cond_spans: Sequence[SpanInfo], *, batch: int,
                 local_steps: int, weighting: str = "fedtgan",
                 participation: float = 1.0, fedprox_mu: float = 0.0,
                 guard: UpdateGuard | None = None,
                 client_chunk: int | None = None,
                 n_edges: int | None = None, dp: DPConfig | None = None):
        if weighting not in WEIGHTINGS:
            raise ValueError(f"unknown weighting {weighting!r}; "
                             f"options: {WEIGHTINGS}")
        if not 0.0 < participation <= 1.0:
            raise ValueError(f"participation must be in (0, 1], "
                             f"got {participation}")
        if client_chunk is not None and client_chunk < 1:
            raise ValueError(f"client_chunk must be >= 1, "
                             f"got {client_chunk}")
        if n_edges is not None and n_edges < 1:
            raise ValueError(f"n_edges must be >= 1, got {n_edges}")
        self.cfg = cfg
        self.weighting = weighting
        self.participation = float(participation)
        self.fedprox_mu = float(fedprox_mu)
        self.guard = guard
        self.client_chunk = client_chunk
        self.n_edges = n_edges
        self.engine = RoundEngine(cfg, tuple(spans), tuple(cond_spans),
                                  batch=batch, local_steps=local_steps, dp=dp)
        if self.fedprox_mu > 0:
            self.engine.step_fn = fedprox_wrap(self.engine.step_fn,
                                               self.fedprox_mu)

    def _merge_flat(self, flat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.n_edges is None:
            return ops.weighted_average_flat(flat, w)
        return tiered_weighted_merge_flat(flat, w, self.n_edges)

    def _merge(self, states: Sequence[GANState],
               w: torch.Tensor) -> torch.Tensor:
        """Flatten every client's generator and critic parameters into the
        ``(P, D)`` stack, merge it in ONE ``weighted_agg`` dispatch (one
        per tier with ``n_edges``) and copy the result back into every
        client.  Returns the stack (the transmitted artifact)."""
        trees = [s.params() for s in states]
        flat = flatten_stacked(trees)
        replicate(unflatten_merged(self._merge_flat(flat, w), trees[0]),
                  trees)
        return flat

    def merge_states(self, states: Sequence[GANState],
                     w: torch.Tensor) -> Sequence[GANState]:
        """Federator merge and redistribution (:meth:`_merge`)."""
        self._merge(states, w)
        return states

    def clients(self, states: Sequence[GANState],
                tables: Sequence[SamplerTables], **inject):
        """Every client's local round (``client_chunk`` checked, see
        :meth:`RoundEngine.clients_round`); under FedProx each client's
        parameters before the round (the broadcast global model) are the
        anchor its steps are pulled toward."""
        aux = None
        if self.fedprox_mu > 0:
            aux = [[t.detach().clone() for t in s.params()] for s in states]
        return self.engine.clients_round(states, tables, aux=aux,
                                         client_chunk=self.client_chunk,
                                         **inject)

    def weighted_round(self, states: Sequence[GANState],
                       tables: Sequence[SamplerTables], w: torch.Tensor, *,
                       draws: Sequence[SamplerDraws] | None = None,
                       noise: Sequence[Sequence[StepNoise]] | None = None):
        """One global round given resolved weights; ``draws`` and ``noise``
        inject every client's draws (see :meth:`RoundEngine.
        clients_round`).  Returns (states, metrics (clients, steps))."""
        return self.traced_round(states, tables, w, draws=draws,
                                 noise=noise)[:2]

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
        return self._rounds(states, tables, S, n_rows, rounds, on_round,
                            keep=False)[:2]

    def traced_round(self, states: Sequence[GANState],
                     tables: Sequence[SamplerTables], w: torch.Tensor, *,
                     draws: Sequence[SamplerDraws] | None = None,
                     noise: Sequence[Sequence] | None = None):
        """One global round that also returns its transmitted artifact:
        the flat ``(P, D)`` post-local-training stack the merge reads
        (port layout: :func:`repro_torch.interop.flat_to_reference` maps it
        to the reference's), what an honest-but-curious federator
        observes.  :meth:`weighted_round` is this round without the
        stack, so a traced round is bit-identical to an untraced one.
        Returns (states, metrics, flat)."""
        states, metrics = self.clients(states, tables, draws=draws,
                                       noise=noise)
        return states, metrics, self._merge(states, w)

    def run_traced(self, states: Sequence[GANState],
                   tables: Sequence[SamplerTables], S: torch.Tensor,
                   n_rows: torch.Tensor, rounds: int, *,
                   on_round: Callable | None = None):
        """:meth:`run` keeping every round's stack.  Returns (states,
        metrics stacked (rounds, clients, steps), ``{"updates": [(P, D)
        per round], "weights": w}``)."""
        return self._rounds(states, tables, S, n_rows, rounds, on_round,
                            keep=True)

    def _rounds(self, states, tables, S, n_rows, rounds, on_round, *,
                keep: bool):
        w = resolve_weights(self.weighting, S, n_rows)
        out, flats = [], []
        for r in range(rounds):
            states, m, flat = self.traced_round(states, tables, w)
            if on_round is not None:
                on_round(r, states, m)
            out.append(m)
            if keep:
                flats.append(flat)
        return states, stack_metrics(out), {"updates": flats, "weights": w}

    def faulted_round(self, states: Sequence[GANState],
                      tables: Sequence[SamplerTables], w: torch.Tensor,
                      fault: FaultPlan, *,
                      generator: torch.Generator | None = None,
                      draws: Sequence[SamplerDraws] | None = None,
                      noise: Sequence[Sequence[StepNoise]] | None = None):
        """One global round under a (P,)-sliced :class:`FaultPlan`.

        With ``participation < 1`` the round's cohort is drawn from
        ``generator`` (:func:`sample_participation`) and combined with the
        plan's mask.  The local rounds run, the faults corrupt the
        transmitted stack, the guard decides the survivors ``ok``; then
        ``w_eff = w * ok``, the stack's masked rows zeroed, ONE
        ``weighted_agg`` launch (one per tier with ``n_edges``)
        renormalizes over the survivors, and a round with no survivor
        keeps the previous model.  A neutral plan gives the dense round's
        parameters.

        Extra metrics: ``client_ok`` (survived mask and guard),
        ``client_suspect`` (the advisory corruption signal the retry
        blocklist reads, guard or not), ``update_norm``, ``w_eff``
        (renormalized) and the 0-dim ``merged`` (False: the round froze).
        """
        dev = w.device
        participate = fault.participate.to(dev)
        if self.participation < 1.0:
            participate = participate & sample_participation(
                w, self.participation, generator=generator)
        trees = [s.params() for s in states]
        prev_flat = flatten_stacked(trees)
        states, metrics = self.clients(states, tables, draws=draws,
                                       noise=noise)
        flat = apply_faults(flatten_stacked(trees), prev_flat,
                            fault.nan_mask.to(dev), fault.scale.to(dev))
        norm_mult = (self.guard.norm_mult if self.guard is not None
                     and self.guard.norm_mult > 0 else DEFAULT_NORM_MULT)
        diag = update_diagnostics(flat, prev_flat, participate,
                                  norm_mult=norm_mult)
        ok = guard_ok(self.guard, diag, participate)
        w_eff = w * ok
        wsum = torch.sum(w_eff)
        merged = self._merge_flat(torch.where(ok[:, None], flat, 0.0), w_eff)
        merged = torch.where(wsum > 0, merged, prev_flat[0])
        replicate(unflatten_merged(merged, trees[0]), trees)
        metrics = dict(metrics, client_ok=ok,
                       client_suspect=participate & diag["suspect"],
                       update_norm=diag["norm"],
                       w_eff=w_eff / torch.clamp(wsum, min=1e-12),
                       merged=wsum > 0)
        return states, metrics

    def run_faulted(self, states: Sequence[GANState],
                    tables: Sequence[SamplerTables], S: torch.Tensor,
                    n_rows: torch.Tensor, plan: FaultPlan, *,
                    generators: Sequence[torch.Generator] | None = None,
                    on_round: Callable | None = None):
        """:meth:`faulted_round` over the plan's rounds, the weights
        resolved once; ``generators[r]`` draws round r's cohort.  Returns
        (states, metrics stacked over the rounds)."""
        if self.participation < 1.0 and (generators is None
                                         or len(generators) < plan.rounds):
            raise ValueError("partial participation needs one generator per "
                             "round of the plan")
        w = resolve_weights(self.weighting, S, n_rows)
        out = []
        for r in range(plan.rounds):
            fault = FaultPlan(*(leaf[r] for leaf in plan))
            states, m = self.faulted_round(
                states, tables, w, fault,
                generator=None if generators is None else generators[r])
            if on_round is not None:
                on_round(r, states, m)
            out.append(m)
        return states, stack_metrics(out)
