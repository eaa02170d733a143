"""Synthesis from a trained generator: encoded rows, then raw tables.

``sample_synthetic_conditional`` is CTGAN's conditional sampling mode (the
condition vectors follow the table's training-by-sampling marginals);
``synthesize_table`` runs either mode and decodes to a raw table.  The
device-resident training round (``RoundEngine``) arrives with the
training slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..gan.ctgan import CTGANConfig, Generator, apply_activations_fused
from ..gan.trainer import sample_synthetic
from ..tabular.encoders import TableEncoders
from .sampler import SamplerDraws, SamplerTables, draw_conditions


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
