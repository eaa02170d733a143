"""The CTGAN generator (Xu et al., NeurIPS'19) in PyTorch: the part of the
model that serving runs.

``Generator`` is the residual MLP of the JAX package's ``gan/ctgan.py``:
each block is Linear -> batch norm -> ReLU, concatenated after its input
(``[h, y]``).  Batch norm always uses the statistics of the batch at hand,
at sampling time too, with the biased variance and eps 1e-5, as the
reference does; ``nn.BatchNorm1d`` in eval mode would use running
statistics instead and give other tables.  Linear weights are stored in
``nn.Linear``'s ``(fan_out, fan_in)`` layout (the reference keeps
``(fan_in, fan_out)``; :mod:`repro_torch.interop` transposes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
from torch import nn

from ..kernels import ops
from ..kernels.ref import GUMBEL_EPS
from ..tabular.encoders import SpanInfo


@dataclasses.dataclass(frozen=True)
class CTGANConfig:
    z_dim: int = 128
    gen_hidden: tuple[int, ...] = (256, 256)
    disc_hidden: tuple[int, ...] = (256, 256)
    pac: int = 10
    tau: float = 0.2
    gp_lambda: float = 10.0
    dropout: float = 0.5
    lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.9
    batch_size: int = 500


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Normalize with this batch's mean and biased variance (ddof 0)."""
    mu = torch.mean(x, dim=0, keepdim=True)
    var = torch.var(x, dim=0, keepdim=True, correction=0)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


class Residual(nn.Module):
    """One CTGAN residual block: ``[h, relu(bn(fc(h)))]``."""

    def __init__(self, fan_in: int, width: int, device=None):
        super().__init__()
        self.fc = nn.Linear(fan_in, width, device=device)
        self.bn_scale = nn.Parameter(torch.ones(width, device=device))
        self.bn_bias = nn.Parameter(torch.zeros(width, device=device))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        y = torch.relu(batch_norm(self.fc(h), self.bn_scale, self.bn_bias))
        return torch.cat([h, y], dim=1)


class Generator(nn.Module):
    """z (B, z_dim) and cond (B, cond_dim) -> logits over the encoded row.

    Initialized as the reference: every weight and bias uniform in
    ``±1/sqrt(fan_in)``, batch-norm scale 1 and bias 0, drawn from
    ``generator``."""

    def __init__(self, in_dim: int, hidden: Sequence[int], data_dim: int, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        blocks, dim = [], in_dim
        for width in hidden:
            blocks.append(Residual(dim, width, device=device))
            dim += width
        self.res = nn.ModuleList(blocks)
        self.out = nn.Linear(dim, data_dim, device=device)
        with torch.no_grad():
            for lin in [b.fc for b in self.res] + [self.out]:
                lim = 1.0 / math.sqrt(lin.in_features)
                for p in (lin.weight, lin.bias):
                    p.uniform_(-lim, lim, generator=generator)

    def forward(self, z: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = torch.cat([z, cond], dim=1)
        for block in self.res:
            h = block(h)
        return self.out(h)


def init_generator(cfg: CTGANConfig, cond_dim: int, data_dim: int, *,
                   generator: torch.Generator | None = None,
                   device: torch.device | str | None = None) -> Generator:
    """A freshly initialized generator for one table."""
    return Generator(cfg.z_dim + cond_dim, cfg.gen_hidden, data_dim,
                     generator=generator, device=device)


def apply_activations(logits: torch.Tensor, spans: Sequence[SpanInfo],
                      uniforms: torch.Tensor, tau: float,
                      hard: bool = False) -> torch.Tensor:
    """Per-span tanh / Gumbel-softmax, one span at a time: the loop oracle
    of :func:`apply_activations_fused`.  ``uniforms`` (N, dim) holds span
    i's draw at ``[start_i, start_i + width_i)``."""
    parts = []
    for s in spans:
        seg = logits[:, s.start:s.start + s.width]
        if s.activation == "tanh":
            parts.append(torch.tanh(seg))
            continue
        u = uniforms[:, s.start:s.start + s.width]
        z = (seg + -torch.log(-torch.log(u + GUMBEL_EPS) + GUMBEL_EPS)) / tau
        e = torch.exp(z - torch.amax(z, dim=1, keepdim=True))
        y = e / torch.sum(e, dim=1, keepdim=True)
        if hard:
            onehot = nn.functional.one_hot(torch.argmax(y, dim=1), s.width)
            y = (onehot.float() - y) + y
        parts.append(y)
    return torch.cat(parts, dim=1)


def apply_activations_fused(logits: torch.Tensor, spans: Sequence[SpanInfo],
                            uniforms: torch.Tensor, tau: float,
                            hard: bool = False) -> torch.Tensor:
    """All spans in ONE ``segment_activations`` dispatch; float32 out."""
    return ops.segment_activations(logits, spans, uniforms, tau, hard=hard)
