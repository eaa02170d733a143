"""Primitive layers, the port's copy of the JAX package's
``models/layers.py``: RMS norm and the dense initializer.

Dense weights are ``(d_in, d_out)`` and applied as ``x @ W``, as in the
reference, so that parameters carry across without a transpose.  The
reference's name-based sharding rules are TPU-mesh tooling and are not
ported (ROADMAP).
"""
from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in float32 and cast back to ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: float | None = None) -> torch.Tensor:
    """A ``(d_in, d_out)`` weight: standard normal draws in float32 on the
    generator's device, times ``scale`` (default ``1 / sqrt(d_in)``), cast
    to ``dtype``."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * s).to(dtype)
