"""Federation bring-up: the §4.1/§4.2 protocol staged for the rounds, the
port's copy of the JAX package's ``fed/setup.py``.

``setup_federation`` runs, in order:

  1. each client's statistics (``compute_client_stats``), never raw rows;
  2. the federator's encoder init (``federated_encoder_init``);
  3. the (P, Q) divergence matrix S from the same protocol data
     (``build_divergence_matrix``, under ``weighting="fedtgan"``) and the
     §4.2 weights;
  4. each client's rows encoded with the global encoders (one
     ``vgm_encode_table`` launch per client) into its conditional sampler
     tables on the device;
  5. ONE model initialized by the federator and copied to every client,
     each with its own random stream.

``tile_federation`` replicates a staged federation's clients out to
thousands without running the protocol again.

Every random stream is seeded from ``seed`` and the stream's index
(:func:`repro_torch.device.seeded_generator`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.encoding import (ClientStats, FederatedInit, client_vgm_dicts,
                             compute_client_stats, federated_encoder_init)
from ..core.weighting import build_divergence_matrix
from ..device import resolve_device, seeded_generator
from ..gan.ctgan import CTGANConfig
from ..gan.trainer import GANState, init_gan_state
from ..synth import DeviceSampler, SamplerTables
from ..tabular.encoders import ColumnSpec, TableEncoders
from .program import WEIGHTINGS, resolve_weights

# the seed streams of one run
STATS, INIT, WEIGHTS, MODEL, ENCODE, CLIENT_RNG = range(6)


@dataclasses.dataclass
class Federation:
    """Protocol outputs and the per-client round inputs of one federation."""
    init: FederatedInit
    enc: TableEncoders
    spans: tuple
    cond_spans: tuple
    tables: list[SamplerTables]    # per client, on the device
    states: list[GANState]         # per client, identical models at start
    S: torch.Tensor                # (P, Q) divergences (zeros unless
                                   # weighting="fedtgan")
    n_rows: torch.Tensor           # (P,) float32 local row counts
    weights: torch.Tensor          # (P,) resolved §4.2 weights
    weighting: str
    client_stats: list[ClientStats]

    @property
    def n_clients(self) -> int:
        return int(self.n_rows.shape[0])

    def fault_plan(self, regime: str, rounds: int, *, seed: int = 0):
        """A named fault regime (see :data:`repro_torch.fed.scenarios.
        FAULTS`) as a validated (rounds, P)
        :class:`~repro_torch.fed.faults.FaultPlan` sized for this
        federation; None for ``"none"``."""
        # lazy: `python -m repro_torch.fed.scenarios` must not find the
        # module imported by the package already
        from .scenarios import build_fault_plan
        return build_fault_plan(regime, rounds, self.n_clients, seed=seed)


def tile_federation(fe: Federation, P: int) -> Federation:
    """A staged federation's clients replicated out to ``P`` clients.

    The §4.1 protocol (client statistics, VGM fits, encoders, encoding) is
    paid once at the base federation's size; client p of the tiled one is
    base client ``p % base``: an independent replica of its state
    (:meth:`GANState.replica`), its sampler tables, divergence row and row
    count.  The tables are read-only, so the tiled clients share the base
    clients' table tensors instead of copying them (at P = 1,024 that
    saves 1,024 copies of the encoded rows).  Every client, the base ones
    included, gets a fresh stream seeded from client 0's seed and its own
    index (the reference's ``fold_in(rng0, i)`` layout), so replicas do
    not draw in lockstep.  The weights are resolved anew on the tiled
    ``S``.  ``P`` must be a multiple of the base client count; ``P ==
    base`` returns ``fe`` itself."""
    base = fe.n_clients
    if P < base or P % base:
        raise ValueError(f"P={P} must be a positive multiple of the base "
                         f"client count {base}")
    if P == base:
        return fe
    reps = P // base
    rng0 = fe.states[0].rng
    states = [fe.states[p % base].replica(
        seeded_generator(rng0.device, rng0.initial_seed(), p))
        for p in range(P)]
    S = fe.S.repeat(reps, 1)
    n_rows = fe.n_rows.repeat(reps)
    return dataclasses.replace(
        fe, tables=[fe.tables[p % base] for p in range(P)], states=states,
        S=S, n_rows=n_rows, weights=resolve_weights(fe.weighting, S, n_rows),
        client_stats=fe.client_stats * reps)


def setup_federation(client_data: Sequence[np.ndarray],
                     schema: Sequence[ColumnSpec], cfg: CTGANConfig,
                     seed: int, weighting: str = "fedtgan", *,
                     device: torch.device | str = "cuda") -> Federation:
    """Run the §4.1 init and §4.2 Step 0 and stage the federation on
    ``device``."""
    if weighting not in WEIGHTINGS:
        raise ValueError(f"unknown weighting {weighting!r}; "
                         f"options: {WEIGHTINGS}")
    dev = resolve_device(device)
    P = len(client_data)
    stats = [compute_client_stats(d, schema, device=dev,
                                  generator=seeded_generator(dev, seed,
                                                             STATS, i))
             for i, d in enumerate(client_data)]
    init = federated_encoder_init(stats, schema, device=dev,
                                  generator=seeded_generator(dev, seed, INIT))
    n_rows = torch.tensor(init.n_rows, dtype=torch.float32, device=dev)
    if weighting == "fedtgan":
        S = build_divergence_matrix(
            schema, init.client_cat_freqs, client_vgm_dicts(stats),
            init.encoders, init.global_cat_freqs,
            generator=seeded_generator(dev, seed, WEIGHTS))
    else:
        S = torch.zeros((P, len(schema)), dtype=torch.float32, device=dev)
    w = resolve_weights(weighting, S, n_rows)

    enc = init.encoders
    tables = [DeviceSampler(
        enc.encode(d, generator=seeded_generator(dev, seed, ENCODE, i))
        .cpu().numpy(), enc, dev).tables for i, d in enumerate(client_data)]
    state0 = init_gan_state(cfg, enc.cond_dim, enc.encoded_dim,
                            generator=seeded_generator(dev, seed, MODEL),
                            rng=seeded_generator(dev, seed, CLIENT_RNG, 0),
                            device=dev)
    states = [state0] + [state0.replica(seeded_generator(dev, seed,
                                                         CLIENT_RNG, i))
                         for i in range(1, P)]
    return Federation(init, enc, tuple(enc.spans()),
                      tuple(enc.condition_spans()), tables, states, S,
                      n_rows, w, weighting, stats)
