"""Unconditional sampling from a CTGAN generator.

The training steps (discriminator, gradient penalty, Adam, the
``segment_activations`` backward) arrive with the training slice.
"""
from __future__ import annotations

import torch

from .ctgan import CTGANConfig, Generator, apply_activations_fused


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
