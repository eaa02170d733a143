"""CTGAN's train step and unconditional sampling.

``make_train_steps`` builds one step, a critic update and then a generator
update (CTGAN's n_critic = 1), as the JAX package's ``gan/trainer.py`` does:

* the critic step draws fakes with the soft activations (``hard=False``)
  and takes no gradient through the generator; its loss is the WGAN
  critic loss plus ``gp_lambda`` times the gradient penalty;
* the generator step uses the critic parameters that this step's critic
  update just produced; its loss is ``-mean(critic(fake)) +
  conditional_loss``, and its gradient reaches the logits through the
  ``segment_activations`` backward.

Every random draw of a step is in a :class:`StepNoise`; one can be
injected (the tests feed the reference's draws), else it is drawn from the
client's own ``torch.Generator`` in :class:`GANState`.

``make_round_batches`` / ``local_train_scan`` are the presampled baseline
the device sampler (:class:`repro_torch.synth.RoundEngine`) replaced: every
batch drawn on the host up front (:meth:`repro_torch.gan.sampler.
ConditionalSampler.presample_rounds`), then the local steps run over them.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..optim import AdamState, adam
from ..tabular.encoders import SpanInfo
from .ctgan import (CTGANConfig, Discriminator, Generator,
                    apply_activations_fused, conditional_loss,
                    gradient_penalty, init_discriminator, init_generator)


@dataclasses.dataclass
class GANState:
    """One client's model and optimizer state.  ``rng`` (on the models'
    device) draws the client's batches and step noise; ``step`` counts the
    train steps taken.  A step updates the state in place."""
    gen: Generator
    disc: Discriminator
    g_opt: AdamState
    d_opt: AdamState
    step: int
    rng: torch.Generator

    def params(self) -> list[torch.Tensor]:
        """Generator then critic parameters: what the federator merges."""
        return list(self.gen.parameters()) + list(self.disc.parameters())

    def replica(self, rng: torch.Generator) -> "GANState":
        """An independent copy of the models and moments with its own
        ``rng``."""
        return GANState(copy.deepcopy(self.gen), copy.deepcopy(self.disc),
                        _copy_adam(self.g_opt), _copy_adam(self.d_opt),
                        self.step, rng)


def _copy_adam(s: AdamState) -> AdamState:
    return AdamState([m.clone() for m in s.mu], [v.clone() for v in s.nu],
                     s.count)


def init_gan_state(cfg: CTGANConfig, cond_dim: int, data_dim: int, *,
                   generator: torch.Generator, rng: torch.Generator,
                   device: torch.device | str) -> GANState:
    """Fresh generator and critic (initialized from ``generator``), zero
    Adam moments, step 0; ``rng`` becomes the state's own generator."""
    gen = init_generator(cfg, cond_dim, data_dim, generator=generator,
                         device=device)
    disc = init_discriminator(cfg, cond_dim, data_dim, generator=generator,
                              device=device)
    opt = adam(cfg.lr, cfg.b1, cfg.b2)
    return GANState(gen, disc, opt.init(list(gen.parameters())),
                    opt.init(list(disc.parameters())), 0, rng)


class StepNoise(NamedTuple):
    """Every random draw of one train step.  ``z_*`` (B, z_dim) normal;
    ``u_*`` (B, data_dim) activation uniforms in the encoded layout;
    ``keep_*`` one bool mask per critic hidden layer (see
    :meth:`Discriminator.keep_shapes`); ``gp_eps`` (B/pac, 1, 1)."""
    z_d: torch.Tensor
    u_d: torch.Tensor
    keep_d_fake: list[torch.Tensor]
    keep_d_real: list[torch.Tensor]
    gp_eps: torch.Tensor
    z_g: torch.Tensor
    u_g: torch.Tensor
    keep_g: list[torch.Tensor]


def draw_step_noise(rng: torch.Generator, cfg: CTGANConfig,
                    disc: Discriminator, batch: int, data_dim: int,
                    device: torch.device) -> StepNoise:
    """One step's draws from ``rng``, in the order of the fields."""
    def normal(n):
        return torch.randn((n, cfg.z_dim), generator=rng, device=device)

    def uniform(shape):
        return torch.rand(shape, generator=rng, device=device)

    def keep():
        return [uniform(s) < 1 - cfg.dropout
                for s in disc.keep_shapes(batch)]
    z_d, u_d = normal(batch), uniform((batch, data_dim))
    keep_fake, keep_real = keep(), keep()
    gp_eps = uniform((batch // cfg.pac, 1, 1))
    z_g, u_g = normal(batch), uniform((batch, data_dim))
    return StepNoise(z_d, u_d, keep_fake, keep_real, gp_eps, z_g, u_g, keep())


def generator_step(state: GANState, opt, cfg: CTGANConfig,
                   spans: Sequence[SpanInfo], cond_spans: Sequence[SpanInfo],
                   cond: torch.Tensor, mask: torch.Tensor, noise
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The generator's half of a step, in place: ``-mean(critic(fake)) +
    conditional_loss`` against the critic as it stands, one Adam update
    of ``state.gen``; ``noise`` supplies ``z_g``, ``u_g`` and ``keep_g``.
    Returns (g_loss, ce), detached."""
    gen, disc = state.gen, state.disc
    logits = gen(noise.z_g, cond)
    fake = apply_activations_fused(logits, spans, noise.u_g, cfg.tau)
    y_fake = disc(torch.cat([fake, cond], dim=1), keep=noise.keep_g)
    ce = conditional_loss(logits, cond, mask, cond_spans)
    g_loss = -torch.mean(y_fake) + ce
    g_params = list(gen.parameters())
    g_grads = torch.autograd.grad(g_loss, g_params)
    state.g_opt = opt.update(g_grads, state.g_opt, g_params)
    return g_loss.detach(), ce.detach()


def critic_grads(wgan: torch.Tensor, pen: torch.Tensor,
                 params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The critic's gradient: the WGAN term's and the penalty's apart, then
    summed.  One autograd call over both would add each weight's
    contributions in the order the engine runs its nodes; on the card the
    penalty's nodes are created on the engine's device thread, numbered
    from that thread's own counter, so the order (and the gradient's
    rounding) would depend on what the process ran before.  Apart, each
    weight gets one contribution from the WGAN term's two critic passes in
    a fixed order, and from the penalty one plus exact zeros.  A weight
    the penalty does not reach gets zeros."""
    g_wgan = torch.autograd.grad(wgan, params)
    g_pen = torch.autograd.grad(pen, params, allow_unused=True)
    return [a if b is None else a + b for a, b in zip(g_wgan, g_pen)]


def make_train_steps(cfg: CTGANConfig, spans: Sequence[SpanInfo],
                     cond_spans: Sequence[SpanInfo]):
    """Returns ``step(state, batch, noise=None) -> metrics``: one critic and
    one generator update of ``state`` in place on ``batch = (cond, mask,
    real)``.  The metrics (``d_loss``, ``g_loss``, ``wgan``, ``gp``, ``ce``)
    are 0-dim tensors on the device; nothing here waits for it."""
    opt = adam(cfg.lr, cfg.b1, cfg.b2)
    spans = tuple(spans)
    cond_spans = tuple(cond_spans)

    def step(state: GANState, batch, noise: StepNoise | None = None):
        cond, mask, real = batch
        gen, disc = state.gen, state.disc
        dev = real.device
        if noise is None:
            noise = draw_step_noise(state.rng, cfg, disc, real.shape[0],
                                    real.shape[1], dev)

        # critic: fakes without a graph through the generator
        with torch.no_grad():
            logits = gen(noise.z_d, cond)
            fake = apply_activations_fused(logits, spans, noise.u_d, cfg.tau)
        fake_in = torch.cat([fake, cond], dim=1)
        real_in = torch.cat([real, cond], dim=1)
        y_fake = disc(fake_in, keep=noise.keep_d_fake)
        y_real = disc(real_in, keep=noise.keep_d_real)
        gp = gradient_penalty(disc, real_in, fake_in, noise.gp_eps)
        wgan = torch.mean(y_fake) - torch.mean(y_real)
        pen = cfg.gp_lambda * gp
        d_loss = wgan + pen
        d_params = list(disc.parameters())
        d_grads = critic_grads(wgan, pen, d_params)
        state.d_opt = opt.update(d_grads, state.d_opt, d_params)

        # generator, against the critic just updated
        g_loss, ce = generator_step(state, opt, cfg, spans, cond_spans,
                                    cond, mask, noise)
        state.step += 1
        return {"d_loss": d_loss.detach(), "g_loss": g_loss,
                "wgan": wgan.detach(), "gp": gp.detach(), "ce": ce}

    return step


def stack_metrics(metrics: Sequence[dict]) -> dict:
    """Per-step (or per-client, per-round) metric dicts stacked on a new
    leading axis."""
    return {k: torch.stack([m[k] for m in metrics])
            for k in (metrics[0] if metrics else ())}


def make_round_batches(samplers, rounds: int, steps_per_round: int,
                       batch: int, *, device: torch.device | str = "cuda"):
    """Every client's (cond, mask, real) batches of a run, staged up front.

    Each client's :class:`~repro_torch.gan.sampler.ConditionalSampler`
    draws all ``rounds x steps x batch`` rows in one vectorized pass; the
    results stack into ``(clients, rounds, steps, batch, ...)`` float32
    tensors on ``device``, one host-to-device copy each."""
    conds, masks, reals = zip(*[s.presample_rounds(rounds, steps_per_round,
                                                   batch) for s in samplers])
    return tuple(torch.from_numpy(np.stack(a)).to(device)
                 for a in (conds, masks, reals))


def local_train_scan(step_fn: Callable, state: GANState, round_batches,
                     noise: Sequence[StepNoise] | None = None):
    """E presampled local steps of ``state`` (in place), in order.
    ``round_batches`` is (cond, mask, real), each with a leading steps
    axis; ``noise`` injects one :class:`StepNoise` per step (else each
    step draws from ``state.rng``).  Returns (state, metrics stacked over
    the steps): the reference's ``lax.scan``, as a loop."""
    cond, mask, real = round_batches
    metrics = [step_fn(state, (cond[e], mask[e], real[e]),
                       None if noise is None else noise[e])
               for e in range(cond.shape[0])]
    return state, stack_metrics(metrics)


@torch.no_grad()
def sample_synthetic(gen: Generator, cfg: CTGANConfig, spans: tuple,
                     cond_dim: int, n_samples: int, hard: bool = True, *,
                     generator: torch.Generator | None = None,
                     z: torch.Tensor | None = None,
                     uniforms: torch.Tensor | None = None) -> torch.Tensor:
    """Synthetic encoded rows with the condition vector zeroed (CTGAN's
    unconditional mode), on the generator's device.

    Noise is injected or drawn: ``z`` (n, z_dim) and the activation
    ``uniforms`` (n, dim); those not given are drawn from ``generator`` in
    that order.  Generator forward + ONE ``segment_activations`` dispatch;
    nothing here waits for the device."""
    dev = gen.out.weight.device
    if z is None:
        z = torch.randn((n_samples, cfg.z_dim), generator=generator,
                        device=dev)
    cond = torch.zeros((n_samples, cond_dim), device=dev)
    logits = gen(z.to(dev), cond)
    if uniforms is None:
        uniforms = torch.rand(logits.shape, generator=generator, device=dev)
    return apply_activations_fused(logits, spans, uniforms.to(dev), cfg.tau,
                                   hard=hard)
