"""Training rounds on the device, and synthesis from a trained generator.

:class:`RoundEngine` runs a client's local round: ONE conditional
``draw_batch`` of ``local_steps x batch`` rows on the device, then that
many train steps, with no host copy in between.  ``clients_round`` runs
every client's local round in turn (the reference vmaps them; a Python
loop over the clients launches the same kernels, and ``torch.func.vmap``
cannot trace a ctypes launch; ``client_chunk`` is checked and changes
nothing else); ``run_round`` and ``run`` are the single-client entry
points (one round; many rounds in turn).  A prebuilt
``step_fn`` replaces the train step, and a round-constant ``aux`` is
handed to every step: the hooks FedProx uses
(:func:`repro_torch.core.fedavg.fedprox_wrap`).  ``dp=`` swaps in the
DP-SGD step (:mod:`repro_torch.gan.dp`); its per-step noise is a
:class:`~repro_torch.gan.dp.DPStepNoise`.

``sample_synthetic_conditional`` is CTGAN's conditional sampling mode (the
condition vectors follow the table's training-by-sampling marginals);
``synthesize_table`` runs either mode and decodes to a raw table.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..gan.ctgan import CTGANConfig, Generator, apply_activations_fused
from ..gan.dp import make_dp_train_steps
from ..gan.trainer import (GANState, StepNoise, make_train_steps,
                           sample_synthetic, stack_metrics)
from ..tabular.encoders import SpanInfo, TableEncoders
from .sampler import SamplerDraws, SamplerTables, draw_batch, draw_conditions


class RoundEngine:
    """Local rounds for one table schema: ``local_steps`` train steps on
    batches of ``batch`` rows drawn on the device."""

    def __init__(self, cfg: CTGANConfig, spans: Sequence[SpanInfo],
                 cond_spans: Sequence[SpanInfo], *, batch: int,
                 local_steps: int, step_fn: Callable | None = None,
                 dp=None):
        """``step_fn(state, batch, noise)`` replaces the train step of
        :func:`repro_torch.gan.trainer.make_train_steps` (FedProx wraps
        it).  ``dp`` (a :class:`repro_torch.gan.dp.DPConfig`) makes it the
        DP-SGD step of :func:`repro_torch.gan.dp.make_dp_train_steps`;
        it excludes ``step_fn``."""
        if dp is not None and step_fn is not None:
            raise ValueError("pass either a prebuilt step_fn or dp=, not "
                             "both (the DP config builds the step)")
        self.cfg = cfg
        self.batch = int(batch)
        self.local_steps = int(local_steps)
        self.cond_dim = sum(s.width for s in cond_spans)
        if dp is not None:
            step_fn = make_dp_train_steps(cfg, tuple(spans), tuple(cond_spans),
                                          l2_clip=dp.l2_clip,
                                          noise_mult=dp.noise_mult)
        self.step_fn = step_fn or make_train_steps(cfg, tuple(spans),
                                                   tuple(cond_spans))

    def local_round(self, state: GANState, tables: SamplerTables, *,
                    draws: SamplerDraws | None = None,
                    noise: Sequence[StepNoise] | None = None, aux=None):
        """E local steps of ``state`` (in place) on one ``draw_batch`` of
        E x batch rows, split into E batches in order.  ``draws`` injects
        the sampler's draws and ``noise`` one :class:`StepNoise` per step;
        what is not injected comes from ``state.rng``.  ``aux``, when
        given, is round-constant context handed to every step as
        ``step_fn(state, (batch, aux), noise)``.  Returns (state, metrics
        stacked over the steps)."""
        E, B = self.local_steps, self.batch
        cond, mask, real = draw_batch(tables, E * B, self.cond_dim,
                                      generator=state.rng, draws=draws)
        metrics = []
        for e in range(E):
            rows = slice(e * B, (e + 1) * B)
            batch = (cond[rows], mask[rows], real[rows])
            metrics.append(self.step_fn(
                state, batch if aux is None else (batch, aux),
                None if noise is None else noise[e]))
        return state, stack_metrics(metrics)

    # the reference's jitted single-client entry point; eager here
    run_round = local_round

    def clients_round(self, states: Sequence[GANState],
                      tables: Sequence[SamplerTables], *,
                      draws: Sequence[SamplerDraws] | None = None,
                      noise: Sequence[Sequence[StepNoise]] | None = None,
                      aux: Sequence | None = None,
                      client_chunk: int | None = None):
        """Every client's :meth:`local_round`, client by client; ``draws``,
        ``noise`` and ``aux`` are per client when given.  Returns (states,
        metrics stacked (clients, steps)).

        ``client_chunk`` is checked as the reference checks it: ``None``
        or ``>= P`` is the dense round; below 1, or not dividing P, raises
        ``ValueError``.  The reference runs a scan of vmapped chunks to
        hold one chunk's activations at a time; here the clients already
        run one at a time, in order, so chunks of them run the same
        sequence of steps and a chunked round is the dense round, bit for
        bit."""
        P = len(states)
        if client_chunk is not None and client_chunk < P and (
                client_chunk < 1 or P % client_chunk):
            raise ValueError(f"client_chunk={client_chunk} must be >= 1 "
                             f"and divide the client count P={P}")

        def pick(x, p):
            return None if x is None else x[p]
        metrics = [self.local_round(st, tb, draws=pick(draws, p),
                                    noise=pick(noise, p),
                                    aux=pick(aux, p))[1]
                   for p, (st, tb) in enumerate(zip(states, tables))]
        return states, stack_metrics(metrics)

    def run(self, state: GANState, tables: SamplerTables, rounds: int, *,
            draws: Sequence[SamplerDraws] | None = None,
            noise: Sequence[Sequence[StepNoise]] | None = None):
        """``rounds`` local rounds of one client in turn; ``draws`` and
        ``noise`` are per round when given.  Returns (state, metrics
        stacked (rounds, steps))."""
        metrics = [self.local_round(
            state, tables, draws=None if draws is None else draws[r],
            noise=None if noise is None else noise[r])[1]
            for r in range(rounds)]
        return state, stack_metrics(metrics)


@torch.no_grad()
def sample_synthetic_conditional(gen: Generator, cfg: CTGANConfig,
                                 spans: tuple, tables: SamplerTables,
                                 cond_dim: int, n_samples: int,
                                 hard: bool = True, *,
                                 generator: torch.Generator | None = None,
                                 draws: SamplerDraws | None = None,
                                 z: torch.Tensor | None = None,
                                 uniforms: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Synthetic encoded rows whose condition vectors are drawn from
    ``tables``.  Noise not injected is drawn from ``generator`` in the
    order: sampler draws, ``z``, activation ``uniforms``.  Nothing here
    waits for the device."""
    dev = gen.out.weight.device
    cond, _, _ = draw_conditions(tables, n_samples, cond_dim,
                                 generator=generator, draws=draws)
    if z is None:
        z = torch.randn((n_samples, cfg.z_dim), generator=generator,
                        device=dev)
    logits = gen(z.to(dev), cond)
    if uniforms is None:
        uniforms = torch.rand(logits.shape, generator=generator, device=dev)
    return apply_activations_fused(logits, spans, uniforms.to(dev), cfg.tau,
                                   hard=hard)


def synthesize_table(gen: Generator, cfg: CTGANConfig, enc: TableEncoders,
                     n_samples: int, *, hard: bool = True,
                     tables: SamplerTables | None = None,
                     generator: torch.Generator | None = None,
                     draws: SamplerDraws | None = None,
                     z: torch.Tensor | None = None,
                     uniforms: torch.Tensor | None = None,
                     device: torch.device | str = "cuda") -> np.ndarray:
    """Generator -> raw (n_samples, Q) float64 table on ``device``: one
    ``segment_activations`` dispatch and one ``vgm_decode_table`` dispatch.

    ``tables`` switches to conditional sampling.  ``generator`` (a
    ``torch.Generator`` on ``device``) draws the noise not injected; the
    same seed gives the same table."""
    dev = resolve_device(device)
    for where, d in (("generator weights", gen.out.weight.device),
                     ("encoders", enc.device)):
        if d != dev:
            raise ValueError(f"synthesize_table: {where} are on {d}, "
                             f"not {dev}")
    spans = tuple(enc.spans())
    if tables is None:
        encoded = sample_synthetic(gen, cfg, spans, enc.cond_dim, n_samples,
                                   hard, generator=generator, z=z,
                                   uniforms=uniforms)
    else:
        encoded = sample_synthetic_conditional(
            gen, cfg, spans, tables, enc.cond_dim, n_samples, hard,
            generator=generator, draws=draws, z=z, uniforms=uniforms)
    return enc.decode_plan().decode(encoded)
