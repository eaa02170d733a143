"""The collective rendering of the global round: one client per rank of a
``torch.distributed`` process group, the port's copy of the JAX package's
``fed/sharded.py`` (there, clients on a mesh axis under ``shard_map``).

Each rank runs its own client's ``RoundEngine.local_round`` on its own
sampler tables (batches drawn on the device, nothing presampled), and the
federator merge is ONE weighted all-reduce over the group
(:func:`repro_torch.core.aggregation.psum_weighted`, the collective twin
of the fused ``weighted_agg`` merge; no kernel of the port runs on this
path's merge, as the reference merges with ``psum``, outside any Pallas
kernel).  The §4.2 weights are resolved on every rank from the same
divergence matrix.

The arguments keep the reference's global view: ``states`` and ``tables``
hold one entry per rank, and rank r trains and merges entry r in place;
the other entries belong to the other ranks.  At a world size of one (a
single card, NCCL) the round is the fused program's round, bit for bit:
the weight is 1 and the all-reduce returns its input.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from ..core.aggregation import psum_weighted
from ..gan.ctgan import CTGANConfig
from ..gan.trainer import GANState
from ..synth import RoundEngine, SamplerDraws, SamplerTables
from ..tabular.encoders import SpanInfo
from .program import resolve_weights


def shard_map_weighted_round(engine: RoundEngine, *,
                             group: dist.ProcessGroup | None = None):
    """``round_fn(states, tables, w, *, draws=None, noise=None) -> (states,
    metrics)``: ``states``, ``tables``, the (P,) weights ``w`` and, when
    given, the injected ``draws`` and ``noise`` carry one entry per rank
    of ``group`` (default: the world).  On rank r: one local round of
    ``states[r]`` on ``tables[r]``, then the weighted all-reduce of its
    generator and critic parameters (the weights sum to 1 over the group).
    The metrics come back (1, local_steps), this rank's row."""
    def round_fn(states: Sequence[GANState], tables: Sequence[SamplerTables],
                 w: torch.Tensor, *,
                 draws: Sequence[SamplerDraws] | None = None,
                 noise: Sequence | None = None):
        size = dist.get_world_size(group)
        if len(states) != size:
            # each rank trains exactly one client: a mismatch would
            # silently drop clients from the merge
            raise ValueError(f"the client states ({len(states)}) must equal "
                             f"the process group's size ({size})")
        r = dist.get_rank(group)
        st, metrics = engine.local_round(
            states[r], tables[r], draws=None if draws is None else draws[r],
            noise=None if noise is None else noise[r])
        psum_weighted(st.params(), w[r], group)
        return states, {k: v[None] for k, v in metrics.items()}

    return round_fn


def shard_map_global_round(cfg: CTGANConfig, spans: Sequence[SpanInfo],
                           cond_spans: Sequence[SpanInfo], *, batch: int,
                           local_steps: int, weighting: str = "fedtgan",
                           group: dist.ProcessGroup | None = None,
                           engine: RoundEngine | None = None):
    """The full global round, collective edition: ``program(states, tables,
    S, n_rows, **inject)`` resolves the §4.2 weights (on every rank), then
    runs :func:`shard_map_weighted_round`.  The reference's mesh and
    client axes become the process group."""
    engine = engine or RoundEngine(cfg, tuple(spans), tuple(cond_spans),
                                   batch=batch, local_steps=local_steps)
    round_fn = shard_map_weighted_round(engine, group=group)

    def program(states, tables, S, n_rows, **inject):
        w = resolve_weights(weighting, S, n_rows)
        return round_fn(states, tables, w, **inject)

    return program
