"""The divergences of Fed-TGAN (§4.2) and its evaluation (§5.2): the
Jensen-Shannon distance for categorical columns and the 1-D Wasserstein
distance for continuous ones, the port's copy of the JAX package's
``core/divergence.py``.

They take numpy arrays or tensors (on any device) and compute in float32,
as the reference does.  The JSD uses base-2 logs, so it lies in [0, 1].
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def _f32(a) -> torch.Tensor:
    """A float32 tensor of ``a``; numpy input is copied (it may be
    read-only)."""
    return (a if isinstance(a, torch.Tensor) else torch.tensor(a)).float()


def kl(p, q) -> torch.Tensor:
    """KL divergence D(p||q) in bits over the last axis (both normalized
    first)."""
    p, q = _f32(p), _f32(q)
    q = q.to(p.device)
    p = p / torch.clamp(torch.sum(p, -1, keepdim=True), min=_EPS)
    q = q / torch.clamp(torch.sum(q, -1, keepdim=True), min=_EPS)
    ratio = (torch.log2(torch.clamp(p, min=_EPS))
             - torch.log2(torch.clamp(q, min=_EPS)))
    return torch.sum(torch.where(p > 0, p * ratio, 0.0), dim=-1)


def jsd(p, q) -> torch.Tensor:
    """Jensen-Shannon distance sqrt((D(p||m) + D(q||m)) / 2), in [0, 1]."""
    p, q = _f32(p), _f32(q)
    q = q.to(p.device)
    pn = p / torch.clamp(torch.sum(p, -1, keepdim=True), min=_EPS)
    qn = q / torch.clamp(torch.sum(q, -1, keepdim=True), min=_EPS)
    m = 0.5 * (pn + qn)
    val = 0.5 * (kl(pn, m) + kl(qn, m))
    return torch.sqrt(torch.clamp(val, min=0.0))


def wasserstein_1d(u, v) -> torch.Tensor:
    """First Wasserstein distance between two 1-D empirical samples, in
    quantile-coupling form: the mean of |F_u^-1(t) - F_v^-1(t)| over the
    grid t = (i + 0.5) / n, n the larger sample count, with linear
    interpolation between order statistics.  Sample counts may differ."""
    u, v = torch.sort(_f32(u))[0], torch.sort(_f32(v))[0]
    v = v.to(u.device)
    n = max(int(u.shape[0]), int(v.shape[0]))
    t = (torch.arange(n, dtype=torch.float32, device=u.device) + 0.5) / n
    return torch.mean(torch.abs(torch.quantile(u, t) - torch.quantile(v, t)))
