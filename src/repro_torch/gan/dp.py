"""Differentially private CTGAN training, the port's copy of the JAX
package's ``gan/dp.py`` (the paper's §5.5 future work).

DP-SGD (Abadi et al. 2016) on the CRITIC, the only network that reads real
rows; the generator never sees data, so its updates inherit the critic's
guarantee by post-processing.  The privacy unit is one PacGAN pack
(``pac`` rows judged together), so the gradient is clipped per pack: the
per-pack gradients come from ONE batched ``torch.func.vmap`` over
``torch.func.grad`` of a pack's loss (its WGAN term plus ``gp_lambda``
times its own gradient penalty), each is clipped to L2 norm ``l2_clip``
(:func:`clip_params`), they are summed, Gaussian noise N(0, (noise_mult x
l2_clip)^2) is added per parameter (:func:`noise_params`), and the sum is
divided by the number of packs before Adam.  The generator's half of the
step is the non-private one.

``dp_epsilon`` is the reference's strong-composition estimate
eps ~= q sqrt(2 T ln(1/delta)) / sigma.

Every draw of a step is in a :class:`DPStepNoise`, taken before the vmap
(explicit ``torch.Generator`` draws cannot run inside it): the
:class:`~repro_torch.gan.trainer.StepNoise` fields, with the critic's
dropout masks and gradient-penalty ``eps`` one row per pack, and one
standard-normal tensor per critic parameter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import torch

from ..optim import adam
from ..tabular.encoders import SpanInfo
from .ctgan import (CTGANConfig, Discriminator, apply_activations_fused,
                    critic_call, gradient_penalty_func)
from .trainer import GANState, draw_step_noise, generator_step


class DPError(ValueError):
    """A DP hyperparameter that would silently void the guarantee
    (non-positive noise, empty step count, sampling rate q > 1, ...).
    Raised instead of returning garbage epsilon / un-noised updates."""


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Per-pack clip + Gaussian-noise settings for the DP'd round.

    ``l2_clip`` bounds each pack's gradient L2 norm; ``noise_mult`` is the
    DP-SGD sigma/clip ratio; ``delta`` the target failure probability of
    the (eps, delta) guarantee.  Validated at construction."""
    l2_clip: float = 1.0
    noise_mult: float = 1.0
    delta: float = 1e-5

    def __post_init__(self):
        if not (self.l2_clip > 0 and math.isfinite(self.l2_clip)):
            raise DPError(f"l2_clip must be finite and > 0, "
                          f"got {self.l2_clip}")
        if not (self.noise_mult > 0 and math.isfinite(self.noise_mult)):
            raise DPError(f"noise_mult must be finite and > 0, "
                          f"got {self.noise_mult} (use dp=None for the "
                          f"non-private path; noise 0 is not DP)")
        if not 0.0 < self.delta < 1.0:
            raise DPError(f"delta must be in (0, 1), got {self.delta}")

    def epsilon(self, steps: int, batch: int, n_rows: int) -> float:
        """(eps, self.delta) spent after ``steps`` updates at this batch
        size over ``n_rows`` local rows."""
        return dp_epsilon(steps, batch, n_rows, self.noise_mult,
                          delta=self.delta)


def dp_epsilon(steps: int, batch: int, n_rows: int, noise_mult: float,
               delta: float = 1e-5) -> float:
    """Approximate (eps, delta) after ``steps`` DP updates.

    Raises :class:`DPError` on inputs that would make the estimate
    meaningless: non-positive steps/batch/rows/noise, a subsampling rate
    over 1 (``batch > n_rows``), or delta outside (0, 1)."""
    if not (isinstance(steps, (int,)) or float(steps).is_integer()) \
            or steps <= 0:
        raise DPError(f"steps must be a positive integer, got {steps}")
    if batch <= 0:
        raise DPError(f"batch must be > 0, got {batch}")
    if n_rows <= 0:
        raise DPError(f"n_rows must be > 0, got {n_rows}")
    if batch > n_rows:
        raise DPError(f"batch ({batch}) > n_rows ({n_rows}): the Poisson "
                      f"subsampling rate q would exceed 1 — the epsilon "
                      f"estimate is undefined, not just loose")
    if not (noise_mult > 0 and math.isfinite(noise_mult)):
        raise DPError(f"noise_mult must be finite and > 0, got {noise_mult}")
    if not 0.0 < delta < 1.0:
        raise DPError(f"delta must be in (0, 1), got {delta}")
    q = batch / n_rows
    return q * math.sqrt(2.0 * steps * math.log(1.0 / delta)) / noise_mult


def clip_params(grads: Sequence[torch.Tensor],
                max_norm: float) -> list[torch.Tensor]:
    """Scale ``grads`` so that their GLOBAL (all-tensor) L2 norm is at most
    ``max_norm``: ``min(1, max_norm / sqrt(sum g^2 + 1e-12))``, the sum in
    float32; the identity (up to the regularizer) below the bound."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads)
                    + 1e-12)
    scale = torch.clamp(max_norm / gn, max=1.0)
    return [g * scale.to(g.dtype) for g in grads]


def noise_params(params: Sequence[torch.Tensor], sigma: float,
                 noise: Sequence[torch.Tensor] | None = None, *,
                 generator: torch.Generator | None = None
                 ) -> list[torch.Tensor]:
    """Add iid N(0, sigma^2) to every tensor: ``noise`` holds one standard
    normal tensor per entry of ``params``, drawn from ``generator`` in
    order when not given."""
    if noise is None:
        noise = [torch.randn(p.shape, generator=generator, device=p.device,
                             dtype=p.dtype) for p in params]
    return [p + sigma * n for p, n in zip(params, noise, strict=True)]


class DPStepNoise(NamedTuple):
    """Every draw of one DP step: the fields of
    :class:`~repro_torch.gan.trainer.StepNoise` (``keep_d_*`` one (B/pac,
    h) mask per critic hidden layer, row i for pack i; ``gp_eps`` (B/pac,
    1, 1), one per pack), and ``d_noise``, one standard-normal tensor per
    critic parameter in ``disc.parameters()`` order."""
    z_d: torch.Tensor
    u_d: torch.Tensor
    keep_d_fake: list[torch.Tensor]
    keep_d_real: list[torch.Tensor]
    gp_eps: torch.Tensor
    z_g: torch.Tensor
    u_g: torch.Tensor
    keep_g: list[torch.Tensor]
    d_noise: list[torch.Tensor]


def draw_dp_step_noise(rng: torch.Generator, cfg: CTGANConfig,
                       disc: Discriminator, batch: int, data_dim: int,
                       device: torch.device) -> DPStepNoise:
    """One DP step's draws from ``rng``: :func:`~repro_torch.gan.trainer.
    draw_step_noise`'s, then the critic's Gaussians parameter by
    parameter."""
    base = draw_step_noise(rng, cfg, disc, batch, data_dim, device)
    return DPStepNoise(*base, [torch.randn(p.shape, generator=rng,
                                           device=device)
                               for p in disc.parameters()])


def per_pack_critic_grads(disc: Discriminator, cfg: CTGANConfig,
                          real_in: torch.Tensor, fake_in: torch.Tensor,
                          noise) -> tuple[list[torch.Tensor], tuple]:
    """Each pack's critic gradient, in ONE ``torch.func.vmap`` over
    ``torch.func.grad`` (of the WGAN term and of the penalty, summed):
    pack i (rows ``[i*pac, (i+1)*pac)`` of the critic's real and fake
    inputs) has the loss ``mean(D(fake_i)) -
    mean(D(real_i)) + gp_lambda * gp_i``, its dropout masks the i-th rows
    of ``noise.keep_d_*`` and its penalty's ``eps`` ``noise.gp_eps[i]``.
    Returns (one (n_packs, *shape) gradient per critic parameter, in
    ``disc.parameters()`` order; (loss, wgan, gp) each (n_packs,))."""
    pac = cfg.pac
    n_packs = real_in.shape[0] // pac
    params = {name: p.detach() for name, p in disc.named_parameters()}

    def pack_grads(prm, real_p, fake_p, keep_f, keep_r, eps):
        # the WGAN term's and the penalty's gradients apart, then summed,
        # as trainer.critic_grads does and for the same reason
        def wgan_fn(p):
            y_fake = critic_call(disc, p, fake_p,
                                 keep=[k[None] for k in keep_f])
            y_real = critic_call(disc, p, real_p,
                                 keep=[k[None] for k in keep_r])
            wgan = torch.mean(y_fake) - torch.mean(y_real)
            return wgan, wgan

        def pen_fn(p):
            gp = gradient_penalty_func(disc, p, real_p, fake_p, eps[None])
            return cfg.gp_lambda * gp, gp
        g_wgan, wgan = torch.func.grad(wgan_fn, has_aux=True)(prm)
        g_pen, gp = torch.func.grad(pen_fn, has_aux=True)(prm)
        grads = {k: g_wgan[k] + g_pen[k] for k in g_wgan}
        return grads, (wgan + cfg.gp_lambda * gp, wgan, gp)

    grads, aux = torch.func.vmap(pack_grads, in_dims=(None, 0, 0, 0, 0, 0))(
        params, real_in.reshape(n_packs, pac, -1),
        fake_in.reshape(n_packs, pac, -1), tuple(noise.keep_d_fake),
        tuple(noise.keep_d_real), noise.gp_eps)
    return [grads[name] for name in params], aux


def clip_packs(grads: Sequence[torch.Tensor],
               l2_clip: float) -> list[torch.Tensor]:
    """:func:`clip_params` applied to each pack's gradient (the leading
    axis of every tensor)."""
    return list(torch.func.vmap(lambda *g: tuple(clip_params(g, l2_clip)))(
        *grads))


def make_dp_train_steps(cfg: CTGANConfig, spans: Sequence[SpanInfo],
                        cond_spans: Sequence[SpanInfo], *,
                        l2_clip: float = 1.0, noise_mult: float = 1.0):
    """Like :func:`~repro_torch.gan.trainer.make_train_steps` but with a
    DP critic update: ``step(state, batch, noise=None) -> metrics``, the
    same metric keys (``d_loss`` the mean of the packs' losses, ``wgan``
    and ``gp`` their means, ``g_loss``, ``ce``), ``noise`` a
    :class:`DPStepNoise` drawn from ``state.rng`` when not given.

    The critic step: ONE shared fake batch under ``no_grad`` (one
    ``segment_activations`` launch), the per-pack gradients
    (:func:`per_pack_critic_grads`), each clipped (:func:`clip_packs`),
    summed, noised with sigma ``noise_mult * l2_clip``
    (:func:`noise_params`), divided by the number of packs, and Adam.  The
    generator step is the non-private one.  Raises :class:`DPError` on a
    non-positive clip or noise and on a batch the packs cannot divide."""
    if not (l2_clip > 0 and math.isfinite(l2_clip)):
        raise DPError(f"l2_clip must be finite and > 0, got {l2_clip}")
    if not (noise_mult > 0 and math.isfinite(noise_mult)):
        raise DPError(f"noise_mult must be finite and > 0, got {noise_mult} "
                      f"(noise 0 is clipping, not DP — use the non-private "
                      f"step for that)")
    if cfg.batch_size % cfg.pac:
        raise DPError(f"batch_size ({cfg.batch_size}) must be a multiple of "
                      f"pac ({cfg.pac}): the privacy unit is one pack")
    opt = adam(cfg.lr, cfg.b1, cfg.b2)
    spans = tuple(spans)
    cond_spans = tuple(cond_spans)
    sigma = noise_mult * l2_clip

    def step(state: GANState, batch, noise: DPStepNoise | None = None):
        cond, mask, real = batch
        gen, disc = state.gen, state.disc
        n_packs = real.shape[0] // cfg.pac
        if noise is None:
            noise = draw_dp_step_noise(state.rng, cfg, disc, real.shape[0],
                                       real.shape[1], real.device)

        # one shared fake batch (generated, so public), packed as the real
        with torch.no_grad():
            fake = apply_activations_fused(gen(noise.z_d, cond), spans,
                                           noise.u_d, cfg.tau)
        fake_in = torch.cat([fake, cond], dim=1)
        real_in = torch.cat([real, cond], dim=1)
        per_pack, (dl, wgan, gp) = per_pack_critic_grads(disc, cfg, real_in,
                                                         fake_in, noise)
        summed = [g.sum(dim=0) for g in clip_packs(per_pack, l2_clip)]
        d_grads = [g / n_packs
                   for g in noise_params(summed, sigma, noise.d_noise)]
        state.d_opt = opt.update(d_grads, state.d_opt,
                                 list(disc.parameters()))

        g_loss, ce = generator_step(state, opt, cfg, spans, cond_spans,
                                    cond, mask, noise)
        state.step += 1
        return {"d_loss": torch.mean(dl), "g_loss": g_loss,
                "wgan": torch.mean(wgan), "gp": torch.mean(gp), "ce": ce}

    return step
