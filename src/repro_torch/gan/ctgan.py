"""CTGAN (Xu et al., NeurIPS'19) in PyTorch: the generator, the PacGAN
discriminator and the WGAN-GP and conditional losses that train them.

``Generator`` is the residual MLP of the JAX package's ``gan/ctgan.py``:
each block is Linear -> batch norm -> ReLU, concatenated after its input
(``[h, y]``).  Batch norm always uses the statistics of the batch at hand,
at sampling time too, with the biased variance and eps 1e-5, as the
reference does; ``nn.BatchNorm1d`` in eval mode would use running
statistics instead and give other tables.  Linear weights are stored in
``nn.Linear``'s ``(fan_out, fan_in)`` layout (the reference keeps
``(fan_in, fan_out)``; :mod:`repro_torch.interop` transposes).

``Discriminator`` is the reference's PacGAN critic: ``pac`` rows are
concatenated into one input, then Linear -> LeakyReLU(0.2) -> dropout per
hidden layer and a Linear to one score.  Dropout is written as the
reference writes it, ``where(keep, h / (1 - p), 0)``, and its keep masks
can be injected.  ``critic_call`` and ``gradient_penalty_func`` are the
critic and its penalty in the functional form that ``torch.func``
transforms differentiate (the DP step's per-pack gradients).
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


class Discriminator(nn.Module):
    """PacGAN critic: x (B, data_dim + cond_dim) -> scores (B / pac,).

    Initialized as the reference: every weight and bias uniform in
    ``±1/sqrt(fan_in)``, drawn from ``generator``; the first fan-in is
    ``(data_dim + cond_dim) * pac``."""

    def __init__(self, in_dim: int, hidden: Sequence[int], *, pac: int,
                 dropout: float, generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.pac = int(pac)
        self.dropout = float(dropout)
        layers, dim = [], in_dim * self.pac
        for width in hidden:
            layers.append(nn.Linear(dim, width, device=device))
            dim = width
        self.fc = nn.ModuleList(layers)
        self.out = nn.Linear(dim, 1, device=device)
        with torch.no_grad():
            for lin in list(self.fc) + [self.out]:
                lim = 1.0 / math.sqrt(lin.in_features)
                for p in (lin.weight, lin.bias):
                    p.uniform_(-lim, lim, generator=generator)

    def keep_shapes(self, batch: int) -> list[tuple[int, int]]:
        """The shapes of the dropout keep masks for a batch of rows."""
        return [(batch // self.pac, lin.out_features) for lin in self.fc]

    def forward(self, x: torch.Tensor, *, train: bool = True,
                keep: Sequence[torch.Tensor] | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Scores of the packs of ``x``.  With ``train`` and dropout > 0 each
        hidden layer keeps the units where ``keep[i]`` (bool, see
        :meth:`keep_shapes`) is true; masks not given are drawn from
        ``generator``, keeping each unit with probability ``1 - dropout``."""
        b = x.shape[0] // self.pac
        h = x.reshape(b, -1)
        p = self.dropout
        for i, lin in enumerate(self.fc):
            h = nn.functional.leaky_relu(lin(h), 0.2)
            if train and p > 0:
                k = (keep[i] if keep is not None else
                     torch.rand(h.shape, generator=generator,
                                device=h.device) < 1 - p)
                h = torch.where(k, h / (1 - p), 0.0)
        return self.out(h)[:, 0]


def init_discriminator(cfg: CTGANConfig, cond_dim: int, data_dim: int, *,
                       generator: torch.Generator | None = None,
                       device: torch.device | str | None = None
                       ) -> Discriminator:
    """A freshly initialized critic for one table."""
    return Discriminator(data_dim + cond_dim, cfg.disc_hidden, pac=cfg.pac,
                         dropout=cfg.dropout, generator=generator,
                         device=device)


def gradient_penalty(disc: Discriminator, real: torch.Tensor,
                     fake: torch.Tensor, eps: torch.Tensor | None = None, *,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """WGAN-GP with pac-aware interpolation: one ``eps`` (B/pac, 1, 1) per
    pack, drawn uniform from ``generator`` when not given.  The critic runs
    without dropout; the input gradient keeps its graph
    (``create_graph=True``) so the penalty differentiates w.r.t. the
    critic's parameters."""
    b = real.shape[0] // disc.pac
    if eps is None:
        eps = torch.rand((b, 1, 1), generator=generator, device=real.device)
    r = real.reshape(b, disc.pac, -1)
    f = fake.reshape(b, disc.pac, -1)
    inter = (eps * r + (1 - eps) * f).reshape(real.shape)
    if not inter.requires_grad:
        inter.requires_grad_()
    with torch.enable_grad():
        score = torch.sum(disc(inter, train=False))
        (g,) = torch.autograd.grad(score, inter, create_graph=True)
    g = g.reshape(b, -1)
    gn = torch.sqrt(torch.sum(g * g, dim=1) + 1e-12)
    return torch.mean((gn - 1.0) ** 2)


def critic_call(disc: Discriminator, params: dict, x: torch.Tensor,
                **kw) -> torch.Tensor:
    """``disc(x, **kw)`` computed with ``params`` (parameter name ->
    tensor) in place of the critic's own: the functional form that
    ``torch.func`` transforms differentiate."""
    return torch.func.functional_call(disc, params, (x,), kw)


def gradient_penalty_func(disc: Discriminator, params: dict,
                          real: torch.Tensor, fake: torch.Tensor,
                          eps: torch.Tensor) -> torch.Tensor:
    """:func:`gradient_penalty` for ``torch.func``: the critic runs with
    ``params`` (:func:`critic_call`) and the input gradient comes from
    ``torch.func.grad`` (the transforms refuse ``torch.autograd.grad``),
    so that ``torch.func.grad`` over ``params`` reaches through it.
    ``eps`` (B/pac, 1, 1) is given."""
    b = real.shape[0] // disc.pac
    r = real.reshape(b, disc.pac, -1)
    f = fake.reshape(b, disc.pac, -1)
    inter = (eps * r + (1 - eps) * f).reshape(real.shape)

    def score(x):
        return torch.sum(critic_call(disc, params, x, train=False))
    g = torch.func.grad(score)(inter).reshape(b, -1)
    gn = torch.sqrt(torch.sum(g * g, dim=1) + 1e-12)
    return torch.mean((gn - 1.0) ** 2)


def conditional_loss(logits: torch.Tensor, cond: torch.Tensor,
                     mask: torch.Tensor, spans: Sequence[SpanInfo]
                     ) -> torch.Tensor:
    """Cross-entropy that makes the generator emit the conditioned
    category: ``cond`` is the condition vector over the condition spans,
    ``mask`` (B, n_cond_spans) one-hot selects the span conditioned on."""
    total = torch.zeros(logits.shape[0], device=logits.device)
    pos = 0
    for si, s in enumerate(spans):
        seg = logits[:, s.start:s.start + s.width]
        tgt = cond[:, pos:pos + s.width]
        logp = nn.functional.log_softmax(seg, dim=1)
        ce = -torch.sum(tgt * logp, dim=1)
        total = total + ce * mask[:, si]
        pos += s.width
    return torch.mean(total)


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
            y = (onehot.float() - y.detach()) + y      # ST: the soft grad
        parts.append(y)
    return torch.cat(parts, dim=1)


def apply_activations_fused(logits: torch.Tensor, spans: Sequence[SpanInfo],
                            uniforms: torch.Tensor, tau: float,
                            hard: bool = False) -> torch.Tensor:
    """All spans in ONE ``segment_activations`` dispatch; float32 out."""
    return ops.segment_activations(logits, spans, uniforms, tau, hard=hard)
